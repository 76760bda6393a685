"""InvertedDoublePendulum-v5: its host env and its batch-first functional env.

Counterpart of ``InvertedDoublePendulumEnv`` (the host class behind ``make``) and
``InvertedDoublePendulumFunctional`` in the JAX package's
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
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MujocoEnv
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["InvertedDoublePendulumEnv", "InvertedDoublePendulumFunctional"]

_POLE_LEN = 0.6  # each pole segment's length


def _tip(qpos):
    """The tip's ``(x, y)`` of (N, 3) positions: cart slide, then two hinges."""
    x, a, b = qpos[:, 0], qpos[:, 1], qpos[:, 2]
    tip_x = x + _POLE_LEN * torch.sin(a) + _POLE_LEN * torch.sin(a + b)
    tip_y = _POLE_LEN * torch.cos(a) + _POLE_LEN * torch.cos(a + b)
    return tip_x, tip_y


class InvertedDoublePendulumEnv(MujocoEnv, EzPickle):
    """Balance a two-segment pole on a sliding cart."""

    def __init__(
        self,
        healthy_reward: float = 10.0,
        reset_noise_scale: float = 0.1,
        render_mode: str | None = None,
        **kwargs: Any,
    ):
        EzPickle.__init__(self, healthy_reward, reset_noise_scale, render_mode, **kwargs)
        self._healthy_reward = healthy_reward
        super().__init__(
            "inverted_double_pendulum",
            frame_skip=kwargs.pop("frame_skip", 5),
            observation_space=spaces.Box(-np.inf, np.inf, (9,), np.float64),
            render_mode=render_mode,
            reset_noise_scale=reset_noise_scale,
            **kwargs,
        )
        # obs = [x, sin q1, sin q2, cos q1, cos q2, v0, v1, v2, constraint]:
        # the last is upstream's clip(qfrc_constraint, +-10)[0], here the
        # joint-limit torque on the cart's slide, the one constraint force
        # this model has

    def _sample_initial_state(self):
        noise = self._reset_noise_scale
        qpos = self.init_qpos + self.np_random.uniform(-noise, noise, self.model.nv)
        qvel = self.init_qvel + self.np_random.standard_normal(self.model.nv) * noise
        return qpos, qvel

    def _get_obs(self) -> np.ndarray:
        qfrc = self._helper("limit_torques")
        return np.concatenate(
            [
                self.qpos[:1],
                np.sin(self.qpos[1:]),
                np.cos(self.qpos[1:]),
                np.clip(self.qvel, -10, 10),
                np.clip(qfrc, -10, 10)[:1],
            ]
        ).astype(np.float64)

    def step(self, action):
        self.do_simulation(action)
        obs = self._get_obs()
        q = self.qpos
        tip_x = q[0] + _POLE_LEN * np.sin(q[1]) + _POLE_LEN * np.sin(q[1] + q[2])
        tip_y = _POLE_LEN * np.cos(q[1]) + _POLE_LEN * np.cos(q[1] + q[2])
        dist_penalty = 0.01 * tip_x**2 + (tip_y - 2) ** 2
        v1, v2 = self.qvel[1:3]
        vel_penalty = 1e-3 * v1**2 + 5e-3 * v2**2
        terminated = bool(tip_y <= 1.0)
        alive_bonus = float(self._healthy_reward * (not terminated))
        dist_penalty = float(dist_penalty)
        vel_penalty = float(vel_penalty)
        # upstream's grouping: survive + distance_penalty + velocity_penalty
        reward = alive_bonus + -dist_penalty + -vel_penalty
        if self.render_mode == "human":
            self.render()
        return obs, reward, terminated, False, {
            "reward_survive": alive_bonus,
            "distance_penalty": -dist_penalty,
            "velocity_penalty": -vel_penalty,
        }


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
