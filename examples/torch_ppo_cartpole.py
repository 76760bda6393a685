"""PPO on CartPole with the PyTorch port: rollout, GAE and clipped-surrogate
updates, every tensor on the card.

    python examples/torch_ppo_cartpole.py [--device cuda] [--num-envs N] [--steps T] [--updates U]
"""

import argparse

from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.train.ppo import PPOConfig, train


def main(device: str = "cuda", num_envs: int = 256, steps: int = 128, updates: int = 100) -> dict:
    config = PPOConfig(
        num_envs=num_envs,
        rollout_steps=steps,
        hidden_sizes=(64, 64),
        num_minibatches=4,
        update_epochs=4,
        max_episode_steps=500,
    )
    state = train(CartPoleFunctional(), config, num_updates=updates, seed=0, verbose=True, device=device)
    return {"updates": int(state.update_count), "state": state}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--steps", type=int, default=128, help="rollout steps a train step")
    parser.add_argument("--updates", type=int, default=100)
    main(**vars(parser.parse_args()))
