"""PPO on HalfCheetah with the PyTorch port, with observation AND return
normalization and episode statistics from the functional wrapper layer
(``gymnasium_tpu_torch/wrappers/func.py``) inside each train step.

The wrapper states (running mean/var, return accumulators, episode
statistics) live in the training carry on the card; each env step is one
launch of the articulated kernel there.

    python examples/torch_ppo_halfcheetah_normalized.py [--device cuda] [--num-envs N] [--steps T] [--updates U]
"""

import argparse

from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.train.ppo import PPOConfig, init_ppo, make_train_step
from gymnasium_tpu_torch.wrappers.func import (
    EpisodeStatistics,
    NormalizeObservation,
    NormalizeReward,
)


def main(device: str = "cuda", num_envs: int = 256, steps: int = 64, updates: int = 30) -> dict:
    wrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    config = PPOConfig(
        num_envs=num_envs,
        rollout_steps=steps,
        hidden_sizes=(64, 64),
        num_minibatches=4,
        update_epochs=2,
        max_episode_steps=200,
    )
    env = HalfCheetahFunctional()
    state, env_params = init_ppo(env, config, seed=0, wrappers=wrappers, device=device)
    train_step = make_train_step(env, config, env_params, wrappers=wrappers)

    for update in range(updates):
        state, metrics = train_step(state)
        if update % 5 == 0 or update == updates - 1:
            obs_rms = state.env_carry.wrappers[0]
            print(
                f"update {update:3d}  loss={float(metrics['loss']):+.4f}  "
                f"episodes={int(metrics['episodes_finished'])}  "
                f"obs_rms_count={float(obs_rms.count):.0f}  "
                f"|obs_mean|={float(obs_rms.mean.abs().mean()):.3f}"
            )
    print(f"done: the normalization statistics evolved on {state.obs.device}")
    return {"updates": int(state.update_count), "metrics": metrics, "state": state}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--num-envs", type=int, default=256)
    parser.add_argument("--steps", type=int, default=64, help="rollout steps a train step")
    parser.add_argument("--updates", type=int, default=30)
    main(**vars(parser.parse_args()))
