"""Plain PyTorch reference of the Humanoid-v5 task the benchmark runs.

The biped over :class:`~portbench.reference.physics.Robot` (its own copy of
the model file, ``models/humanoid.npz``), with the task's 348-value
observation and its reward:

- observation: ``qpos[2:]`` (22), ``qvel`` (23), the bodies' static inertia
  rows (130: ``[mass, mass * com (3), inertia diagonal (3), off-diagonal
  (3)]`` a body), their centre-of-mass velocities as rows ``[v_com, 0]``
  (78), a zero actuator-force block (17) and their external contact
  wrenches (78);
- reward: 1.25 times the x velocity of the whole robot's centre of mass
  over ``dt``, plus 5 while ``1 < z < 2`` (open at both ends), minus
  ``0.1 * sum(action^2)`` and ``min(5e-7 * sum(cfrc_ext^2), 10)``;
- termination: the torso's height outside ``1 < z < 2``.

The centre-of-mass velocities are ``sum_k Jv[:, b, k] qd_k`` over the
bodies' linear Jacobians from this module's own kinematics, with the free
root's angular velocity ``qd[3:6]`` in the body frame (its axes are the
root's rotated frame).

Departures from upstream ``humanoid_v5.py``, as the environment this
benchmark runs defines them (also listed under ``departures`` in
``configs/humanoid-v5.json``): the inertia rows are the bodies' static
ones in their own frames, not MuJoCo's world-frame ``cinert``; the
velocity rows are ``[v_com, 0]``, not MuJoCo's ``cvel`` (angular, then
linear, about the subtree's centre of mass); ``qfrc_actuator`` reads
zeros; the reset's velocity noise is normal with ``reset_noise_scale`` as
its standard deviation, not uniform; contacts are the model's spheres
against the ground plane, soft, as :mod:`portbench.reference.physics`
states them, not MuJoCo's geoms and constraint solver.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference.physics import Locomotion


class Humanoid(Locomotion):
    """Humanoid-v5 over its :class:`~portbench.reference.physics.Robot`,
    from a cell's configuration (its ``task`` group)."""

    def __init__(self, config: dict):
        super().__init__(config)
        r = self.robot
        # one row a body: the model's 13 bodies are the observation's 13 rows
        self.cinert = np.concatenate([
            np.concatenate([[m], m * com, np.diag(inertia), [inertia[0, 1], inertia[0, 2], inertia[1, 2]]])
            for m, com, inertia in zip(r.mass, r.com, r.inertia)])
        # float32 products in full precision, as the check's own are
        torch.backends.cuda.matmul.allow_tf32 = False

    def _kinematics(self, q):
        c = self.robot.tables(q.device, q.dtype)
        R, p, axes, pivots = self.robot.kinematics(q, c)
        return c, axes, pivots, p + (R @ c["com"][None, :, :, None])[..., 0]

    def com_velocity(self, q, qd):
        """Each body's centre-of-mass velocity in the world frame, ``(N, nbody, 3)``."""
        c, axes, pivots, pc = self._kinematics(q)
        ax_b = axes[:, None].expand(-1, self.robot.nbody, -1, -1)
        lever = pc[:, :, None, :] - pivots[:, None, :, :]
        Jv = torch.where(c["slide"][None, None, :, None], ax_b, torch.linalg.cross(ax_b, lever, dim=-1))
        return torch.einsum("nbkx,nk->nbx", Jv * c["amask"][None, :, :, None], qd)

    def mass_center_x(self, q):
        """The whole robot's centre of mass along x, ``(N,)``."""
        c, *_, pc = self._kinematics(q)
        return torch.sum(c["mass"] * pc[..., 0], -1) / torch.sum(c["mass"])

    def observation(self, q, qd):
        n = q.shape[0]
        vel = self.com_velocity(q, qd)
        cvel = torch.cat([vel, torch.zeros_like(vel)], -1).reshape(n, -1)
        cinert = torch.as_tensor(self.cinert, device=q.device).to(q.dtype).expand(n, -1)
        qfrc = q.new_zeros((n, self.robot.nv - 6))
        cfrc = self.robot.contact_wrenches(q, qd).reshape(n, -1)
        return torch.cat([q[:, self.exclude:], qd, cinert, cvel, qfrc, cfrc], 1)

    def healthy(self, q, qd):
        z = q[:, 2]
        return (z > self.healthy_z[0]) & (z < self.healthy_z[1])

    def terminated(self, q, qd):
        return ~self.healthy(q, qd)

    def reward(self, q_before, q, qd, action, judged_q=None):
        """The step's reward from the state before ``q_before`` to ``(q,
        qd)``; ``judged_q``, where given, is the state whose torso height
        the healthy bonus reads."""
        s = self.spec
        r = s["forward_reward_weight"] * (self.mass_center_x(q) - self.mass_center_x(q_before)) / self.robot.dt
        r = r + s["healthy_reward"] * self.healthy(q if judged_q is None else judged_q, qd)
        r = r - s["ctrl_cost_weight"] * torch.sum(action * action, -1)
        cf = self.robot.contact_wrenches(q, qd)
        low, high = s["contact_cost_range"]  # null: no bound on that side
        cost = torch.clamp(s["contact_cost_weight"] * torch.sum(cf * cf, (1, 2)), min=low, max=high)
        return r - cost
