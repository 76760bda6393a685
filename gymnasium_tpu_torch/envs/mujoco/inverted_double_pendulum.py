"""InvertedDoublePendulum-v5 as a batch-first functional env.

Counterpart of ``InvertedDoublePendulumFunctional`` in the JAX package's
``envs/mujoco/inverted_double_pendulum.py``: the observation holds the cart,
the sines and cosines of the hinges, the clipped velocities and the cart's
clipped joint-limit torque; the reward is 10 while the tip stands above 1,
minus the tip's distance from upright and a velocity penalty.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv

__all__ = ["InvertedDoublePendulumFunctional"]

_POLE_LEN = 0.6  # each pole segment's length


def _tip(qpos):
    """The tip's ``(x, y)`` of (N, 3) positions: cart slide, then two hinges."""
    x, a, b = qpos[:, 0], qpos[:, 1], qpos[:, 2]
    tip_x = x + _POLE_LEN * torch.sin(a) + _POLE_LEN * torch.sin(a + b)
    tip_y = _POLE_LEN * torch.cos(a) + _POLE_LEN * torch.cos(a + b)
    return tip_x, tip_y


class InvertedDoublePendulumFunctional(MujocoFuncEnv):
    """Balance a two-segment pole on a sliding cart."""

    model_name = "inverted_double_pendulum"
    frame_skip = 5
    reset_noise_scale = 0.1

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (9,), np.float32)

    def observation(self, state, rng, params: Any = None):
        q, qd = state["qpos"], state["qvel"]
        qfrc = self._dyn["limit_torques"](q, qd)
        return torch.cat(
            [
                q[:, :1],
                torch.sin(q[:, 1:]),
                torch.cos(q[:, 1:]),
                torch.clamp(qd, -10.0, 10.0),
                torch.clamp(qfrc, -10.0, 10.0)[:, :1],
            ],
            dim=1,
        )

    def reward(self, state, action, next_state, rng, params: Any = None):
        tip_x, tip_y = _tip(next_state["qpos"])
        dist_penalty = 0.01 * tip_x**2 + (tip_y - 2) ** 2
        v1, v2 = next_state["qvel"][:, 1], next_state["qvel"][:, 2]
        vel_penalty = 1e-3 * v1**2 + 5e-3 * v2**2
        alive = torch.where(tip_y > 1.0, 10.0, 0.0)
        return alive - dist_penalty - vel_penalty

    def terminal(self, state, rng, params: Any = None):
        _, tip_y = _tip(state["qpos"])
        return tip_y <= 1.0
