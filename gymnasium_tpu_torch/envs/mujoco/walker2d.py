"""Walker2d-v5 as a batch-first functional env.

Counterpart of ``Walker2dFunctional`` in the JAX package's
``envs/mujoco/walker2d.py``: observation ``qpos[1:] ++ clip(qvel, +-10)``,
reward forward velocity plus 1 minus 1e-3 times the squared action; the
episode ends when the torso leaves ``0.8 < z < 2`` or tilts past 1 rad.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv

__all__ = ["Walker2dFunctional"]


class Walker2dFunctional(MujocoFuncEnv):
    """Walk forward on two legs in the plane."""

    model_name = "walker2d_v5"
    frame_skip = 4
    reset_noise_scale = 5e-3

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (17,), np.float32)

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 1:], torch.clamp(state["qvel"], -10.0, 10.0)], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 1e-3 * torch.sum(torch.square(action), dim=-1)
        return x_velocity + 1.0 - ctrl_cost

    def terminal(self, state, rng, params: Any = None):
        z, angle = state["qpos"][:, 1], state["qpos"][:, 2]
        return ~((z > 0.8) & (z < 2.0) & (torch.abs(angle) < 1.0))
