"""Humanoid-v5 as a batch-first functional env.

Counterpart of ``HumanoidFunctional`` in the JAX package's
``envs/mujoco/humanoid.py``: a biped on a free root with the 348-value
observation (positions, velocities, the static per-body inertia block, the
bodies' centre-of-mass velocities, a zero actuator-force block and the
bodies' external contact wrenches). The reward is 1.25 times the forward
velocity of the whole robot's centre of mass, plus 5 while healthy, minus
the control and contact costs; the episode ends when the torso leaves
``1 < z < 2``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.physics.articulated import integrate_pos

__all__ = ["HumanoidFunctional"]

# the per-body observation blocks have one row a body, the world excluded
_NBODY_OBS = 13


def _com_inertia_block(model) -> np.ndarray:
    """Static per-body rows ``[mass, mass * com (3), inertia diagonal (3),
    inertia off-diagonal (3)]``, ``_NBODY_OBS`` rows flattened (130 values)."""
    rows = []
    for b in range(len(model.bodies.mass)):
        m = model.bodies.mass[b]
        inertia = model.bodies.inertia[b]
        rows.append(
            np.concatenate(
                [[m], m * model.bodies.com[b], np.diag(inertia), [inertia[0, 1], inertia[0, 2], inertia[1, 2]]]
            )
        )
    rows = rows[:_NBODY_OBS]
    while len(rows) < _NBODY_OBS:
        rows.append(np.zeros(10))
    return np.concatenate(rows)


class HumanoidFunctional(MujocoFuncEnv):
    """Walk forward without falling over."""

    model_name = "humanoid"
    frame_skip = 5
    reset_noise_scale = 1e-2

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (348,), np.float32)
        self._cinert = _com_inertia_block(self.model)

    def com_velocity(self, q, qd):
        """World velocity (N, nbody, 3) of each body's centre of mass: the
        forward derivative of ``com_world(integrate_pos(q, qd, t))`` at
        ``t = 0``, along the quaternion retraction of the free root."""

        def com(t):
            return self._dyn["com_world"](integrate_pos(self.model, q, qd, t))[0]

        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        return torch.func.jvp(com, (zero,), (torch.ones_like(zero),))[1]

    def observation(self, state, rng, params: Any = None):
        q, qd = state["qpos"], state["qvel"]
        n = q.shape[0]
        vel = self.com_velocity(q, qd)[:, :_NBODY_OBS]
        rows = torch.cat([vel, torch.zeros_like(vel)], dim=2).reshape(n, -1)
        cinert = self.constant("cinert", self._cinert, q.device).expand(n, -1)
        qfrc = torch.zeros((n, self.model.nv - 6), dtype=q.dtype, device=q.device)
        cfrc_ext = self._dyn["contact_wrenches"](q, qd)[:, :_NBODY_OBS].reshape(n, -1)
        # z, the quaternion and the joints are qpos[2:]
        return torch.cat([q[:, 2:], qd, cinert, rows, qfrc, cfrc_ext], dim=1)

    def _com_x(self, q):
        pc, _ = self._dyn["com_world"](q)
        masses = self.constant("mass", self.model.bodies.mass, q.device)
        return torch.sum(masses * pc[..., 0], dim=-1) / torch.sum(masses)

    def reward(self, state, action, next_state, rng, params: Any = None):
        q = next_state["qpos"]
        x_velocity = (self._com_x(q) - self._com_x(state["qpos"])) / self.dt
        z = q[:, 2]
        healthy = (z > 1.0) & (z < 2.0)
        ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=-1)
        cfrc = self._dyn["contact_wrenches"](q, next_state["qvel"])
        contact_cost = torch.clamp(5e-7 * torch.sum(torch.square(cfrc), dim=(1, 2)), max=10.0)
        return 1.25 * x_velocity + torch.where(healthy, 5.0, 0.0) - ctrl_cost - contact_cost

    def terminal(self, state, rng, params: Any = None):
        z = state["qpos"][:, 2]
        return ~((z > 1.0) & (z < 2.0))
