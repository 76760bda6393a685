"""Walker2d-v5: its host env and its batch-first functional env.

Counterpart of ``Walker2dEnv`` (the host class behind ``make``) and
``Walker2dFunctional`` in the JAX package's
``envs/mujoco/walker2d.py``: observation ``qpos[1:] ++ clip(qvel, +-10)``,
reward forward velocity plus 1 minus 1e-3 times the squared action; the
episode ends when the torso leaves ``0.8 < z < 2`` or tilts past 1 rad.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv, PlanarLocomotionEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["Walker2dEnv", "Walker2dFunctional"]


class Walker2dEnv(PlanarLocomotionEnv, EzPickle):
    """Walk forward on two legs without falling."""

    forward_reward_weight = 1.0
    ctrl_cost_weight = 1e-3
    healthy_reward = 1.0
    velocity_clip = 10.0
    z_index = 1

    def __init__(
        self,
        forward_reward_weight: float = 1.0,
        ctrl_cost_weight: float = 1e-3,
        healthy_reward: float = 1.0,
        terminate_when_unhealthy: bool = True,
        healthy_z_range: tuple[float, float] = (0.8, 2.0),
        healthy_angle_range: tuple[float, float] = (-1.0, 1.0),
        reset_noise_scale: float = 5e-3,
        exclude_current_positions_from_observation: bool = True,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(
            self,
            forward_reward_weight,
            ctrl_cost_weight,
            healthy_reward,
            terminate_when_unhealthy,
            healthy_z_range,
            healthy_angle_range,
            reset_noise_scale,
            exclude_current_positions_from_observation,
            render_mode,
            **kwargs,
        )
        self.forward_reward_weight = forward_reward_weight
        self.ctrl_cost_weight = ctrl_cost_weight
        self.healthy_reward = healthy_reward
        self.terminate_when_unhealthy = terminate_when_unhealthy
        self._healthy_z_range = healthy_z_range
        self._healthy_angle_range = healthy_angle_range
        self.exclude_x = exclude_current_positions_from_observation
        obs_dim = 17 if exclude_current_positions_from_observation else 18
        super().__init__(
            "walker2d_v5",
            frame_skip=kwargs.pop("frame_skip", 4),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )

    def is_healthy(self) -> bool:
        z, angle = self.qpos[1], self.qpos[2]
        min_z, max_z = self._healthy_z_range
        min_angle, max_angle = self._healthy_angle_range
        return bool(min_z < z < max_z and min_angle < angle < max_angle)


class Walker2dFunctional(MujocoFuncEnv):
    """Walk forward on two legs in the plane."""

    model_name = "walker2d_v5"
    frame_skip = 4
    reset_noise_scale = 5e-3

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (17,), np.float32)

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 1:], torch.clamp(state["qvel"], -10.0, 10.0)], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 1e-3 * torch.sum(torch.square(action), dim=-1)
        return x_velocity + 1.0 - ctrl_cost

    def terminal(self, state, rng, params: Any = None):
        z, angle = state["qpos"][:, 1], state["qpos"][:, 2]
        return ~((z > 0.8) & (z < 2.0) & (torch.abs(angle) < 1.0))
