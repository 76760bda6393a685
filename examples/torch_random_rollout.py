"""The classic stateful API on the PyTorch port: ``make`` / ``reset`` /
``step`` over LunarLander, whose solver ticks run on the card.

    python examples/torch_random_rollout.py [--device cuda] [--steps N]
"""

import argparse

import gymnasium_tpu_torch as gym


def main(device: str = "cuda", steps: int | None = None, seed: int = 42) -> dict:
    """One episode of random actions (at most ``steps`` steps)."""
    env = gym.make("LunarLander-v3", device=device)
    obs, info = env.reset(seed=seed)
    env.action_space.seed(seed)
    total, taken = 0.0, 0
    while steps is None or taken < steps:
        action = env.action_space.sample()
        obs, reward, terminated, truncated, info = env.step(action)
        total += float(reward)
        taken += 1
        if terminated or truncated:
            break
    print(f"episode finished after {taken} steps, return {total:.1f}")
    env.close()
    return {"steps": taken, "return": total, "obs": obs}


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--steps", type=int, default=None, help="stop after this many steps")
    parser.add_argument("--seed", type=int, default=42)
    main(**vars(parser.parse_args()))
