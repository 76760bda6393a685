"""InvertedPendulum-v5 as a batch-first functional env.

Counterpart of ``InvertedPendulumFunctional`` in the JAX package's
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

__all__ = ["InvertedPendulumFunctional"]


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
