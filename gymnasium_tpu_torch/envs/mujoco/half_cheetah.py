"""HalfCheetah-v5: its host env and its batch-first functional env.

Counterpart of ``HalfCheetahEnv`` (the host class behind ``make``) and
``HalfCheetahFunctional`` in the JAX package's
``envs/mujoco/half_cheetah.py``: forward velocity minus 0.1 times the
squared action, observation ``qpos[1:] ++ qvel``, never terminal.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv, PlanarLocomotionEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["HalfCheetahEnv", "HalfCheetahFunctional"]


class HalfCheetahEnv(PlanarLocomotionEnv, EzPickle):
    """Run forward as fast as possible."""

    forward_reward_weight = 1.0
    ctrl_cost_weight = 0.1
    terminate_when_unhealthy = False

    def __init__(
        self,
        forward_reward_weight: float = 1.0,
        ctrl_cost_weight: float = 0.1,
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
        self.exclude_x = exclude_current_positions_from_observation
        obs_dim = 17 if exclude_current_positions_from_observation else 18
        super().__init__(
            "half_cheetah",
            frame_skip=kwargs.pop("frame_skip", 5),
            observation_space=spaces.Box(-np.inf, np.inf, (obs_dim,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )

    def _sample_initial_state(self):
        noise = self._reset_noise_scale
        qpos = self.init_qpos + self.np_random.uniform(low=-noise, high=noise, size=self.model.nv)
        qvel = self.init_qvel + noise * self.np_random.standard_normal(self.model.nv)
        return qpos, qvel


class HalfCheetahFunctional(MujocoFuncEnv):
    """Run forward as fast as possible."""

    model_name = "half_cheetah"
    frame_skip = 5

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.observation_space = spaces.Box(-np.inf, np.inf, (17,), np.float32)

    def reward(self, state, action, next_state, rng, params: Any = None):
        x_velocity = (next_state["qpos"][:, 0] - next_state["prev_x"]) / self.dt
        ctrl_cost = 0.1 * torch.sum(torch.square(action), dim=-1)
        return x_velocity - ctrl_cost
