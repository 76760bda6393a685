"""Continuous-action mountain car: the host env class (copy of the JAX
package's ``envs/classic_control/continuous_mountain_car.py``).

Bit-exact parity target: reference classic_control/continuous_mountain_car.py.
The reference's scalar step mixes float32 state with float64 ``math.cos``
intermediates under NEP-50 promotion rules, so this host step mirrors that
exact scalar dance instead of using the shared array dynamics (the
functional env uses ``envs/dynamics/mountain_car.py`` uniformly). It runs on
the host and takes no device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.classic_control.utils import maybe_parse_reset_bounds
from gymnasium_tpu_torch.envs.dynamics.mountain_car import ContinuousMountainCarParams


class Continuous_MountainCarEnv(gym.Env[np.ndarray, np.ndarray]):
    """Mountain car with continuous thrust and an energy penalty."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(self, render_mode: str | None = None, goal_velocity: float = 0):
        self.params = ContinuousMountainCarParams(goal_velocity=goal_velocity)
        self.min_action = self.params.min_action
        self.max_action = self.params.max_action
        self.min_position = self.params.min_position
        self.max_position = self.params.max_position
        self.max_speed = self.params.max_speed
        self.goal_position = self.params.goal_position
        self.goal_velocity = goal_velocity
        self.power = self.params.power

        self.low_state = np.array([self.min_position, -self.max_speed], dtype=np.float32)
        self.high_state = np.array([self.max_position, self.max_speed], dtype=np.float32)

        self.render_mode = render_mode
        self._display = None

        self.action_space = spaces.Box(
            low=self.min_action, high=self.max_action, shape=(1,), dtype=np.float32
        )
        self.observation_space = spaces.Box(
            low=self.low_state, high=self.high_state, dtype=np.float32
        )

        self.state: np.ndarray | None = None

    def step(self, action: np.ndarray):
        position = self.state[0]
        velocity = self.state[1]
        force = min(max(action[0], self.min_action), self.max_action)

        velocity += force * self.power - 0.0025 * math.cos(3 * position)
        if velocity > self.max_speed:
            velocity = self.max_speed
        if velocity < -self.max_speed:
            velocity = -self.max_speed
        position += velocity
        if position > self.max_position:
            position = self.max_position
        if position < self.min_position:
            position = self.min_position
        if position == self.min_position and velocity < 0:
            velocity = 0

        terminated = bool(position >= self.goal_position and velocity >= self.goal_velocity)

        reward = 0.0
        if terminated:
            reward = 100.0
        reward -= math.pow(action[0], 2) * 0.1

        self.state = np.array([position, velocity], dtype=np.float32)

        if self.render_mode == "human":
            self.render()
        return self.state, reward, terminated, False, {}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        low, high = maybe_parse_reset_bounds(options, -0.6, -0.4)
        # float64 at reset, narrowing to float32 only after the first step —
        # parity with the reference's mixed-precision state handling.
        self.state = np.array([self.np_random.uniform(low=low, high=high), 0])

        if self.render_mode == "human":
            self.render()
        return np.array(self.state, dtype=np.float32), {}

    def render(self):
        if self.render_mode is None:
            gym.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return None
        from gymnasium_tpu_torch.envs.classic_control.mountain_car import _render_mountain_car

        frame = _render_mountain_car(self.state, self.params)
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(
                    600, 400, self.metadata["render_fps"], "MountainCarContinuous"
                )
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None
