"""State snapshots of a MuJoCo-class host env (testing helpers).

Counterpart of the JAX package's ``envs/mujoco/utils.py`` (upstream
gymnasium/envs/mujoco/utils.py:12-76). The engine's whole physics state is
``(qpos, qvel)``, so a snapshot is their concatenation.
"""

from __future__ import annotations

import numpy as np

__all__ = ["get_state", "set_state", "check_mujoco_reset_state"]


def get_state(env, state_type=None) -> np.ndarray:
    """A snapshot of ``env``'s whole physics state."""
    env = env.unwrapped
    qpos, qvel = env.get_state()
    return np.concatenate([qpos, qvel])


def set_state(env, state: np.ndarray, state_type=None) -> None:
    """Restore a :func:`get_state` snapshot."""
    env = env.unwrapped
    nq = env.model.nq
    env.set_state(state[:nq], state[nq:])


def check_mujoco_reset_state(env, seed=1234, state_type=None) -> None:
    """Assert that ``reset(seed)`` restores the same physics state after a step."""
    env.action_space.seed(seed)
    action = env.action_space.sample()

    env.reset(seed=seed)
    first = get_state(env)
    env.step(action)

    env.reset(seed=seed)
    second = get_state(env)

    assert np.all(first == second), "reset is not deterministic"
