"""Hopper-v5 as a batch-first functional env.

Counterpart of ``HopperFunctional`` in the JAX package's
``envs/mujoco/hopper.py``: observation ``qpos[1:] ++ clip(qvel, +-10)``,
reward forward velocity plus 1 minus 1e-3 times the squared action; the
episode ends when the state leaves its healthy range.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv

__all__ = ["HopperFunctional"]


class HopperFunctional(MujocoFuncEnv):
    """Hop forward on one leg."""

    model_name = "hopper"
    frame_skip = 4
    reset_noise_scale = 5e-3

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (11,), np.float32)

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 1:], torch.clamp(state["qvel"], -10.0, 10.0)], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 1e-3 * torch.sum(torch.square(action), dim=-1)
        return x_velocity + 1.0 - ctrl_cost

    def terminal(self, state, rng, params: Any = None):
        qpos = state["qpos"]
        z, angle = qpos[:, 1], qpos[:, 2]
        sv = torch.cat([qpos, state["qvel"]], dim=1)[:, 2:]
        healthy = (torch.abs(sv) < 100.0).all(dim=1) & (z > 0.7) & (torch.abs(angle) < 0.2)
        return ~healthy
