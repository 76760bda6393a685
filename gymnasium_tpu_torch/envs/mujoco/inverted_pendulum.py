"""InvertedPendulum-v5: its host env and its batch-first functional env.

Counterpart of ``InvertedPendulumEnv`` (the host class behind ``make``) and
``InvertedPendulumFunctional`` in the JAX package's
``envs/mujoco/inverted_pendulum.py``: observation ``qpos ++ qvel``, reward 1
while the pole stays within 0.2 rad of upright, which is also when the
episode goes on.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["InvertedPendulumEnv", "InvertedPendulumFunctional"]


class InvertedPendulumEnv(MujocoEnv, EzPickle):
    """Balance a pole on a sliding cart."""

    def __init__(
        self,
        reset_noise_scale: float = 0.01,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(self, reset_noise_scale, render_mode, **kwargs)
        super().__init__(
            "inverted_pendulum",
            frame_skip=kwargs.pop("frame_skip", 2),
            observation_space=spaces.Box(-np.inf, np.inf, (4,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )

    def _get_obs(self) -> np.ndarray:
        return np.concatenate([self.qpos, self.qvel]).astype(np.float64)

    def step(self, action):
        self.do_simulation(action)
        obs = self._get_obs()
        terminated = bool(not np.isfinite(obs).all() or (np.abs(obs[1]) > 0.2))
        reward = float(not terminated)
        if self.render_mode == "human":
            self.render()
        return obs, reward, terminated, False, {"reward_survive": reward}


class InvertedPendulumFunctional(MujocoFuncEnv):
    """Balance a pole on a cart."""

    model_name = "inverted_pendulum"
    frame_skip = 2
    reset_noise_scale = 0.01

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (4,), np.float32)

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"], state["qvel"]], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        return torch.where(torch.abs(next_state["qpos"][:, 1]) > 0.2, 0.0, 1.0)

    def terminal(self, state, rng, params: Any = None):
        return torch.abs(state["qpos"][:, 1]) > 0.2
