"""Humanoid-v5: its host env and its batch-first functional env.

Counterpart of ``HumanoidEnv`` (the host class behind ``make``) and
``HumanoidFunctional`` in the JAX package's
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
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.ops.com_kinematics import ComKinematics, com_kinematics_of
from gymnasium_tpu_torch.utils.ezpickle import EzPickle
from gymnasium_tpu_torch.utils.tracing import span

__all__ = ["HumanoidEnv", "HumanoidFunctional", "com_velocity"]

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


def com_velocity(com: ComKinematics, q, qd):
    """World velocity (N, nbody, 3) of each body's centre of mass: the
    first-order velocity along the position flow ``q (+) t qd`` at ``t = 0``
    (:func:`~gymnasium_tpu_torch.physics.articulated.integrate_pos`, with the
    quaternion retraction of the free root), from the bodies' Jacobians.
    ``com`` is the model's
    :func:`~gymnasium_tpu_torch.ops.com_kinematics.com_kinematics_of`: one
    launch of its generated kernel on a CUDA tensor, its plain twin on a CPU
    tensor."""
    with span("mujoco.com_velocity"):
        return com.velocity(q, qd)


class HumanoidEnv(MujocoEnv, EzPickle):
    """Walk forward without falling over."""

    model_name_default = "humanoid"

    def __init__(
        self,
        forward_reward_weight: float = 1.25,
        ctrl_cost_weight: float = 0.1,
        contact_cost_weight: float = 5e-7,
        contact_cost_range: tuple[float, float] = (-np.inf, 10.0),
        healthy_reward: float = 5.0,
        terminate_when_unhealthy: bool = True,
        healthy_z_range: tuple[float, float] = (1.0, 2.0),
        reset_noise_scale: float = 1e-2,
        exclude_current_positions_from_observation: bool = True,
        include_cinert_in_observation: bool = True,
        include_cvel_in_observation: bool = True,
        include_qfrc_actuator_in_observation: bool = True,
        include_cfrc_ext_in_observation: bool = True,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(
            self,
            forward_reward_weight,
            ctrl_cost_weight,
            contact_cost_weight,
            contact_cost_range,
            healthy_reward,
            terminate_when_unhealthy,
            healthy_z_range,
            reset_noise_scale,
            exclude_current_positions_from_observation,
            include_cinert_in_observation,
            include_cvel_in_observation,
            include_qfrc_actuator_in_observation,
            include_cfrc_ext_in_observation,
            render_mode,
            **kwargs,
        )
        self.forward_reward_weight = forward_reward_weight
        self.ctrl_cost_weight = ctrl_cost_weight
        self.healthy_reward = healthy_reward
        self.terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._exclude_xy = exclude_current_positions_from_observation
        self.contact_cost_weight = contact_cost_weight
        self._contact_cost_range = contact_cost_range
        self._include_cinert = include_cinert_in_observation
        self._include_cvel = include_cvel_in_observation
        self._include_qfrc = include_qfrc_actuator_in_observation
        self._include_cfrc = include_cfrc_ext_in_observation
        # 22 + 23, cinert 130, cvel 78, qfrc_actuator[6:] 17, cfrc_ext 78
        # (upstream humanoid_v5.py:436-470: 348 values by default)
        obs_dim = 45 if exclude_current_positions_from_observation else 47
        obs_dim += 130 * include_cinert_in_observation
        obs_dim += 78 * include_cvel_in_observation
        obs_dim += 17 * include_qfrc_actuator_in_observation
        obs_dim += 78 * include_cfrc_ext_in_observation
        super().__init__(
            self.model_name_default,
            frame_skip=kwargs.pop("frame_skip", 5),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )
        self._cinert = _com_inertia_block(self.model)
        self._com = com_kinematics_of(self.model)
        self._last_ctrl = np.zeros(self.model.nu)

    @property
    def torso_z(self) -> float:
        """The torso's height."""
        return float(self.qpos[2])

    def is_healthy(self) -> bool:
        min_z, max_z = self._healthy_z_range
        return bool(min_z < self.torso_z < max_z)

    def _compute(self, name: str, q, qd):
        if name == "com_velocity":
            return com_velocity(self._com, q, qd)
        return super()._compute(name, q, qd)

    def _com_velocity_block(self) -> np.ndarray:
        vel = self._helper("com_velocity")
        rows = [np.concatenate([vel[b], np.zeros(3)]) for b in range(min(len(vel), _NBODY_OBS))]
        while len(rows) < _NBODY_OBS:
            rows.append(np.zeros(6))
        return np.concatenate(rows)

    def _get_obs(self) -> np.ndarray:
        # the free root: qpos[3:7] its orientation, qvel[3:6] its body-frame
        # angular velocity, MuJoCo's layout
        position = np.concatenate([np.array([self.torso_z]), self.qpos[3:7], self.qpos[7:]])
        if not self._exclude_xy:
            position = np.concatenate([self.qpos[:2], position])
        parts = [position, self.qvel]
        if self._include_cinert:
            parts.append(self._cinert)
        if self._include_cvel:
            parts.append(self._com_velocity_block())
        if self._include_qfrc:
            qfrc_actuator = np.zeros(self.model.nv)
            qfrc_actuator[self.model.act_dof] = self.model.act_gear * self._last_ctrl
            parts.append(qfrc_actuator[6:])  # upstream's qfrc_actuator[6:] (17)
        if self._include_cfrc:
            parts.append(self.cfrc_ext[:_NBODY_OBS].reshape(-1))
        return np.concatenate(parts).astype(np.float64)

    def _reset_info(self):
        # upstream humanoid_v5.py:534-541, without the tendon keys (no tendons here)
        return {
            "x_position": self.qpos[0],
            "y_position": self.qpos[1],
            "distance_from_origin": np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2]),
        }

    def _sample_initial_state(self):
        noise = self._reset_noise_scale
        qpos = self.init_qpos + self.np_random.uniform(-noise, noise, self.model.nq)
        qpos[3:7] /= np.linalg.norm(qpos[3:7]) + 1e-24
        qvel = self.init_qvel + self.np_random.uniform(-noise, noise, self.model.nv)
        return qpos, qvel

    def step(self, action):
        # the forward velocity is the whole robot's centre of mass's
        # (upstream humanoid_v5.py:473-477), not the root frame's
        xy_before = self.mass_center_xy()
        self.do_simulation(action)
        self._last_ctrl = np.clip(
            np.asarray(action), self.model.act_ctrlrange[:, 0], self.model.act_ctrlrange[:, 1]
        )
        xy_after = self.mass_center_xy()
        x_velocity, y_velocity = (xy_after - xy_before) / self.dt

        forward_reward = float(self.forward_reward_weight * x_velocity)
        healthy = self.is_healthy()
        healthy_reward = float(self.healthy_reward * (healthy or not self.terminate_when_unhealthy))
        ctrl_cost = self.ctrl_cost_weight * float(np.sum(np.square(action)))
        # over the wrenches, clipped (upstream humanoid_v5.py:422-427)
        contact_cost = float(
            np.clip(self.contact_cost_weight * np.sum(np.square(self.cfrc_ext)), *self._contact_cost_range)
        )

        # upstream's grouping: (forward + survive) + (reward_ctrl + reward_contact)
        reward = (forward_reward + healthy_reward) + (-ctrl_cost + -contact_cost)
        terminated = self.terminate_when_unhealthy and not healthy
        info = {
            # positions of the root frame, velocities of the centre of mass
            "x_position": float(self.qpos[0]),
            "y_position": float(self.qpos[1]),
            "x_velocity": float(x_velocity),
            "y_velocity": float(y_velocity),
            "distance_from_origin": float(np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2])),
            "reward_forward": float(forward_reward),
            "reward_ctrl": -ctrl_cost,
            "reward_contact": -contact_cost,
            "reward_survive": float(healthy_reward),
        }
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, terminated, False, info


class HumanoidFunctional(MujocoFuncEnv):
    """Walk forward without falling over."""

    model_name = "humanoid"
    frame_skip = 5
    reset_noise_scale = 1e-2

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (348,), np.float32)
        self._cinert = _com_inertia_block(self.model)
        self._com = com_kinematics_of(self.model)

    def com_velocity(self, q, qd):
        """:func:`com_velocity` of this env's model."""
        return com_velocity(self._com, q, qd)

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
        """The whole robot's mass centre along x (N,): one launch of the
        model's generated kernel on a CUDA tensor, its plain twin on a CPU
        tensor."""
        with span("mujoco.mass_center"):
            return self._com.mass_center_x(q)

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
