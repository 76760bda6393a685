"""HalfCheetah-v5 as a batch-first functional env.

Counterpart of ``HalfCheetahFunctional`` in the JAX package's
``envs/mujoco/half_cheetah.py``: forward velocity minus 0.1 times the
squared action, observation ``qpos[1:] ++ qvel``, never terminal.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv

__all__ = ["HalfCheetahFunctional"]


class HalfCheetahFunctional(MujocoFuncEnv):
    """Run forward as fast as possible."""

    model_name = "half_cheetah"
    frame_skip = 5

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (17,), np.float32)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=-1)
        return x_velocity - ctrl_cost
