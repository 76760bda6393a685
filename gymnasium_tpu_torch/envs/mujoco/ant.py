"""Ant-v5: its host env and its batch-first functional env.

Counterpart of ``AntEnv`` (the host class behind ``make``) and
``AntFunctional`` in the JAX package's ``envs/mujoco/ant.py``:
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
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["AntEnv", "AntFunctional"]


def _healthy_z(z):
    return (z >= 0.2) & (z <= 1.0)


class AntEnv(MujocoEnv, EzPickle):
    """Coordinate four legs to move forward."""

    def __init__(
        self,
        forward_reward_weight: float = 1.0,
        ctrl_cost_weight: float = 0.5,
        contact_cost_weight: float = 5e-4,
        contact_force_range: tuple[float, float] = (-1.0, 1.0),
        healthy_reward: float = 1.0,
        terminate_when_unhealthy: bool = True,
        healthy_z_range: tuple[float, float] = (0.2, 1.0),
        reset_noise_scale: float = 0.1,
        exclude_current_positions_from_observation: bool = True,
        include_cfrc_ext_in_observation: bool = True,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(
            self,
            forward_reward_weight,
            ctrl_cost_weight,
            contact_cost_weight,
            contact_force_range,
            healthy_reward,
            terminate_when_unhealthy,
            healthy_z_range,
            reset_noise_scale,
            exclude_current_positions_from_observation,
            include_cfrc_ext_in_observation,
            render_mode,
            **kwargs,
        )
        self.forward_reward_weight = forward_reward_weight
        self.ctrl_cost_weight = ctrl_cost_weight
        self.contact_cost_weight = contact_cost_weight
        self._contact_force_range = contact_force_range
        self.healthy_reward = healthy_reward
        self.terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._exclude_xy = exclude_current_positions_from_observation
        self._include_cfrc = include_cfrc_ext_in_observation
        # 13 + 14 (+2 with xy), and 13 bodies x 6 of cfrc_ext (upstream
        # ant_v5.py:393-404: 105 values by default)
        obs_dim = 27 if exclude_current_positions_from_observation else 29
        if include_cfrc_ext_in_observation:
            obs_dim += 13 * 6
        super().__init__(
            "ant",
            frame_skip=kwargs.pop("frame_skip", 5),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )

    def _reset_info(self):
        return {
            "x_position": self.qpos[0],
            "y_position": self.qpos[1],
            "distance_from_origin": np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2]),
        }

    def _sample_initial_state(self):
        noise = self._reset_noise_scale
        qpos = self.init_qpos + self.np_random.uniform(-noise, noise, self.model.nq)
        qpos[3:7] /= np.linalg.norm(qpos[3:7]) + 1e-24
        qvel = self.init_qvel + noise * self.np_random.standard_normal(self.model.nv)
        return qpos, qvel

    @property
    def torso_z(self) -> float:
        """The torso's height."""
        return float(self.qpos[2])

    def is_healthy(self) -> bool:
        min_z, max_z = self._healthy_z_range
        return bool(np.isfinite(self.state_vector()).all() and min_z <= self.torso_z <= max_z)

    def _get_obs(self) -> np.ndarray:
        # the free root's quaternion is qpos[3:7] and qvel[3:6] its body-frame
        # angular velocity: MuJoCo's layout
        parts = [] if self._exclude_xy else [self.qpos[:2]]
        parts += [np.array([self.torso_z]), self.qpos[3:7], self.qpos[7:], self.qvel]
        if self._include_cfrc:
            parts.append(self.cfrc_ext.reshape(-1))
        return np.concatenate(parts).astype(np.float64)

    def step(self, action):
        xy_before = self.qpos[:2].copy()
        self.do_simulation(action)
        xy_after = self.qpos[:2]
        x_velocity, y_velocity = (xy_after - xy_before) / self.dt

        forward_reward = float(self.forward_reward_weight * x_velocity)
        healthy = self.is_healthy()
        healthy_reward = float(self.healthy_reward * (healthy or not self.terminate_when_unhealthy))
        ctrl_cost = self.ctrl_cost_weight * float(np.sum(np.square(action)))
        # over the clipped wrenches (upstream ant_v5.py:328-339)
        contact_cost = self.contact_cost_weight * float(
            np.sum(np.square(np.clip(self.cfrc_ext, *self._contact_force_range)))
        )

        # upstream's grouping: rewards = forward + healthy, costs = ctrl + contact
        reward = (healthy_reward + forward_reward) - (ctrl_cost + contact_cost)
        terminated = self.terminate_when_unhealthy and not healthy
        info = {
            "x_position": float(xy_after[0]),
            "y_position": float(xy_after[1]),
            "distance_from_origin": float(np.linalg.norm(self.qpos[0:2] - self.init_qpos[0:2])),
            "x_velocity": float(x_velocity),
            "y_velocity": float(y_velocity),
            "reward_forward": float(forward_reward),
            "reward_ctrl": -ctrl_cost,
            "reward_contact": -contact_cost,
            "reward_survive": float(healthy_reward),
        }
        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, terminated, False, info


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
