"""Swimmer-v5, three links in a viscous fluid: its host env and its functional env.

Counterpart of ``SwimmerEnv`` (the host class behind ``make``) and
``SwimmerFunctional`` in the JAX package's
``envs/mujoco/swimmer.py``: forward velocity minus 1e-4 times the squared
action, observation ``qpos[2:] ++ qvel`` (8 values), never terminal,
``frame_skip=4``. Each of the four substeps adds the fluid's drag to the
velocities and then takes one launch of the articulated kernel built for
Swimmer at ``frame_skip=1`` (its plain twin on a CPU batch), where the JAX
functional scans its engine's ``step``.

The drag is MuJoCo's inertia-box fluid model, as the JAX step applies it:
each body is the box of its inertia, with full sides ``d_i = sqrt(6 (I_j +
I_k - I_i) / m)``, and in its principal frame the medium applies a viscous
(Stokes) force ``-3 pi D mu v`` and torque ``-pi D^3 mu w`` (``D`` the mean
side) and a quadratic force ``-rho d_j d_k |v_i| v_i / 2`` and torque
``-rho d_i (d_j^4 + d_k^4) |w_i| w_i / 64``. The generalised force is the
gradient in ``qd`` of the power ``F . v + T . w`` with the wrench held
fixed. The velocities are linear in ``qd`` (``v = Jv qd``, ``w = Jw qd``),
so that gradient is ``Jv^T F + Jw^T T`` in closed form, and the step needs
no autograd under ``torch.no_grad`` or ``torch.inference_mode``.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv, PlanarLocomotionEnv
from gymnasium_tpu_torch.ops.articulated_step import fused_step
from gymnasium_tpu_torch.physics.articulated import spd_solve
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["SwimmerEnv", "SwimmerFunctional"]


def fluid_tables(model) -> dict[str, np.ndarray]:
    """The inertia boxes of ``model``'s bodies, in float64: ``diam`` (B,), the
    mean side; ``area`` (B, 3), ``d_j d_k`` by principal axis; ``tdrag`` (B, 3),
    ``d_i (d_j^4 + d_k^4) / 64``; ``axes`` (B, 3, 3), the principal axes in
    the body frame (columns)."""
    mass = np.maximum(np.asarray(model.bodies.mass, np.float64), 1e-12)
    evals, evecs = np.linalg.eigh(np.asarray(model.bodies.inertia, np.float64))
    d_box = np.sqrt(np.maximum(1e-12, (evals.sum(-1, keepdims=True) - 2 * evals)) * 6.0 / mass[:, None])
    d4 = d_box**4
    return {
        "diam": d_box.mean(-1),
        "area": d_box.prod(-1, keepdims=True) / d_box,
        "tdrag": d_box * (d4.sum(-1, keepdims=True) - d4) / 64.0,
        "axes": evecs,
    }


class SwimmerFunctional(MujocoFuncEnv):
    """Swim forward through the viscous fluid."""

    model_name = "swimmer"
    frame_skip = 4

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (8,), np.float32)
        # one kernel launch a substep: the drag comes between substeps
        self._step = fused_step(self.model_name, 1)
        self._fluid = fluid_tables(self.model)

    def drag_torques(self, q, qd):
        """The fluid's generalised force (N, nv) at ``(q, qd)``."""
        rho, mu = float(self.model.fluid_density), float(self.model.fluid_viscosity)
        dev = q.device
        diam, area, tdrag, evecs = (self.constant(k, self._fluid[k], dev) for k in ("diam", "area", "tdrag", "axes"))
        _, R, Jv, Jw = self._dyn["jacobians"](q)
        v = torch.sum(Jv * qd[:, None, :, None], dim=2)  # (N, B, 3) centre-of-mass velocity
        w = torch.sum(Jw * qd[:, None, :, None], dim=2)  # (N, B, 3) angular velocity
        axes = torch.sum(R[..., :, :, None] * evecs[:, None, :, :], dim=-2)  # principal axes in the world
        v_p = torch.sum(axes * v[..., :, None], dim=-2)
        w_p = torch.sum(axes * w[..., :, None], dim=-2)
        force = torch.zeros_like(v_p)
        torque = torch.zeros_like(w_p)
        if mu > 0:
            force = force - 3.0 * math.pi * mu * diam[:, None] * v_p
            torque = torque - math.pi * mu * (diam**3)[:, None] * w_p
        if rho > 0:
            force = force - 0.5 * rho * area * torch.abs(v_p) * v_p
            torque = torque - rho * tdrag * torch.abs(w_p) * w_p
        # the wrench back in the world frame, then Jv^T F + Jw^T T
        f_world = torch.sum(axes * force[..., None, :], dim=-1)
        t_world = torch.sum(axes * torque[..., None, :], dim=-1)
        return torch.sum(Jv * f_world[:, :, None, :] + Jw * t_world[:, :, None, :], dim=(1, 3))

    def swim(self, q, qd, ctrl, frame_skip: int):
        """``frame_skip`` substeps from ``(q, qd)`` under ``ctrl``: each adds
        the drag's velocity change, then launches the ``frame_skip=1`` build."""
        eye = self.constant("eye", np.eye(self.model.nv), q.device)
        for _ in range(frame_skip):
            tau = self.drag_torques(q, qd)
            M = self._dyn["mass_matrix"](q)
            qd = qd + self.model.timestep * spd_solve(M + 1e-9 * eye, tau)
            q, qd = self._step(q, qd, ctrl)
        return q, qd

    def transition(self, state, action, rng, params: Any = None):
        q, qd = self.swim(state["qpos"], state["qvel"], action, self.frame_skip)
        return {"qpos": q, "qvel": qd, "prev_x": state["qpos"][:, 0]}

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 2:], state["qvel"]], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        return x_velocity - 1e-4 * torch.sum(torch.square(action), dim=-1)


class SwimmerEnv(PlanarLocomotionEnv, EzPickle):
    """Swim forward through the viscous fluid.

    An env step is ``frame_skip`` launches of Swimmer's ``frame_skip=1``
    build, the fluid's drag added to the velocities before each.
    """

    forward_reward_weight = 1.0
    ctrl_cost_weight = 1e-4
    terminate_when_unhealthy = False
    report_xy = True

    def __init__(
        self,
        forward_reward_weight: float = 1.0,
        ctrl_cost_weight: float = 1e-4,
        reset_noise_scale: float = 0.1,
        exclude_current_positions_from_observation: bool = True,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(
            self,
            forward_reward_weight,
            ctrl_cost_weight,
            reset_noise_scale,
            exclude_current_positions_from_observation,
            render_mode,
            **kwargs,
        )
        self.forward_reward_weight = forward_reward_weight
        self.ctrl_cost_weight = ctrl_cost_weight
        self._exclude_xy = exclude_current_positions_from_observation
        obs_dim = 8 if exclude_current_positions_from_observation else 10
        super().__init__(
            "swimmer",
            frame_skip=kwargs.pop("frame_skip", 4),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )
        self._fluid = SwimmerFunctional()
        self._step = self._fluid._step  # the frame_skip=1 build

    def _advance(self, q, qd, ctrl):
        return self._fluid.swim(q, qd, ctrl, self.frame_skip)

    def _get_obs(self) -> np.ndarray:
        qpos = self.qpos[2:] if self._exclude_xy else self.qpos
        return np.concatenate([qpos, self.qvel]).astype(np.float64)
