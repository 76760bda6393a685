"""Ant-v5 as a batch-first functional env.

Counterpart of ``AntFunctional`` in the JAX package's ``envs/mujoco/ant.py``:
a quadruped on a free root. The observation is the torso height, its
quaternion, the joints, every velocity and each body's external contact
wrench (105 values); the reward is forward velocity, plus 1 while healthy,
minus the control cost and the contact cost of the clipped wrenches; the
episode ends when the torso leaves ``0.2 <= z <= 1.0`` or a value is not finite.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv

__all__ = ["AntFunctional"]


def _healthy_z(z):
    return (z >= 0.2) & (z <= 1.0)


class AntFunctional(MujocoFuncEnv):
    """Coordinate four legs to move forward."""

    model_name = "ant"
    frame_skip = 5
    reset_noise_scale = 0.1

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (105,), np.float32)

    def observation(self, state, rng, params: Any = None):
        q, qd = state["qpos"], state["qvel"]
        cfrc_ext = self._dyn["contact_wrenches"](q, qd).reshape(q.shape[0], -1)
        # z, the quaternion and the joints are qpos[2:]
        return torch.cat([q[:, 2:], qd, cfrc_ext], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        q = next_state["qpos"]
        x_velocity = (q[:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 0.5 * torch.sum(torch.square(action), dim=-1)
        cfrc = self._dyn["contact_wrenches"](q, next_state["qvel"])
        contact_cost = 5e-4 * torch.sum(torch.square(torch.clamp(cfrc, -1.0, 1.0)), dim=(1, 2))
        return x_velocity + torch.where(_healthy_z(q[:, 2]), 1.0, 0.0) - ctrl_cost - contact_cost

    def terminal(self, state, rng, params: Any = None):
        q, qd = state["qpos"], state["qvel"]
        finite = torch.isfinite(q).all(dim=1) & torch.isfinite(qd).all(dim=1)
        return ~(_healthy_z(q[:, 2]) & finite)
