"""Hopper-v5: its host env and its batch-first functional env.

Counterpart of ``HopperEnv`` (the host class behind ``make``) and
``HopperFunctional`` in the JAX package's
``envs/mujoco/hopper.py``: observation ``qpos[1:] ++ clip(qvel, +-10)``,
reward forward velocity plus 1 minus 1e-3 times the squared action; the
episode ends when the state leaves its healthy range.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv, PlanarLocomotionEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["HopperEnv", "HopperFunctional"]


class HopperEnv(PlanarLocomotionEnv, EzPickle):
    """Hop forward without falling."""

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
        healthy_state_range: tuple[float, float] = (-100.0, 100.0),
        healthy_z_range: tuple[float, float] = (0.7, float("inf")),
        healthy_angle_range: tuple[float, float] = (-0.2, 0.2),
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
            healthy_state_range,
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
        self._healthy_state_range = healthy_state_range
        self._healthy_z_range = healthy_z_range
        self._healthy_angle_range = healthy_angle_range
        self.exclude_x = exclude_current_positions_from_observation
        obs_dim = 11 if exclude_current_positions_from_observation else 12
        super().__init__(
            "hopper",
            frame_skip=kwargs.pop("frame_skip", 4),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )

    def is_healthy(self) -> bool:
        z, angle = self.qpos[1], self.qpos[2]
        state = self.state_vector()[2:]
        min_state, max_state = self._healthy_state_range
        min_z, max_z = self._healthy_z_range
        min_angle, max_angle = self._healthy_angle_range
        return (
            bool(np.all(np.logical_and(min_state < state, state < max_state)))
            and min_z < z < max_z
            and min_angle < angle < max_angle
        )


class HopperFunctional(MujocoFuncEnv):
    """Hop forward on one leg."""

    model_name = "hopper"
    frame_skip = 4
    reset_noise_scale = 5e-3

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (11,), np.float32)

    def observation(self, state, rng, params: Any = None):
        return torch.cat([state["qpos"][:, 1:], torch.clamp(state["qvel"], -10.0, 10.0)], dim=1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 1e-3 * torch.sum(torch.square(action), dim=-1)
        return x_velocity + 1.0 - ctrl_cost

    def terminal(self, state, rng, params: Any = None):
        qpos = state["qpos"]
        z, angle = qpos[:, 1], qpos[:, 2]
        sv = torch.cat([qpos, state["qvel"]], dim=1)[:, 2:]
        healthy = (torch.abs(sv) < 100.0).all(dim=1) & (z > 0.7) & (torch.abs(angle) < 0.2)
        return ~healthy
