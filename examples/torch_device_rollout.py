"""The device path of the PyTorch port: the whole CartPole batch lives on
the card, and ``TorchVectorEnv.rollout`` runs a trajectory without handing
anything back to the host until it ends.

    python examples/torch_device_rollout.py [--device cuda] [--num-envs N] [--steps T]
"""

import argparse
import time

import torch

import gymnasium_tpu_torch as gym


def synchronize(device: str) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def main(device: str = "cuda", num_envs: int = 4096, steps: int = 1024) -> dict:
    """A warm-up rollout, then a timed one continuing from its carry."""
    env = gym.make_vec("CartPole-v1", num_envs, vectorization_mode="torch",
                       vector_kwargs={"device": device, "seed": 0})
    env.reset()

    carry, traj = env.rollout(steps)  # warm-up
    synchronize(device)

    start = time.perf_counter()
    # continue from the previous carry: fresh inputs give honest timing
    carry, traj = env.rollout(steps, carry=carry)
    synchronize(device)
    elapsed = time.perf_counter() - start

    rate = num_envs * steps / elapsed
    print(f"obs trajectory: {tuple(traj.obs.shape)} {traj.obs.dtype} on {traj.obs.device}")
    print(f"{rate / 1e6:.1f} M env-steps/s")
    print(f"mean reward: {float(traj.reward.float().mean()):.4f}")
    env.close()
    return {"obs_shape": tuple(traj.obs.shape), "env_steps_per_s": rate, "traj": traj}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--steps", type=int, default=1024)
    main(**vars(parser.parse_args()))
