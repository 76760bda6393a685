"""Discrete-action mountain car: the host env class (copy of the JAX
package's ``envs/classic_control/mountain_car.py``), on the host in numpy.

Bit-exact parity target: reference classic_control/mountain_car.py:132-155.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.classic_control.utils import maybe_parse_reset_bounds
from gymnasium_tpu_torch.envs.dynamics.mountain_car import MountainCarParams, integrate, is_goal


def _render_mountain_car(state, params, width=600, height=400, marker=None):
    """Rasterize the hill, car, and goal flag from state."""
    from gymnasium_tpu_torch.utils.raster import Canvas

    canvas = Canvas(width, height)
    world_width = params.max_position - params.min_position
    scale = width / world_width

    def height_of(x):
        return np.sin(3 * x) * 0.45 + 0.55

    xs = np.linspace(params.min_position, params.max_position, 100)
    ys = height_of(xs)
    pts = list(zip((xs - params.min_position) * scale, height - ys * scale))
    for a, b in zip(pts[:-1], pts[1:]):
        canvas.line(a, b, (0, 0, 0), 2)

    pos = float(state[0])
    car_x = (pos - params.min_position) * scale
    car_y = height - height_of(pos) * scale
    canvas.circle((car_x, car_y - 10), 10, (0, 0, 0))

    flag_x = (params.goal_position - params.min_position) * scale
    flag_y = height - height_of(params.goal_position) * scale
    canvas.line((flag_x, flag_y), (flag_x, flag_y - 50), (0, 0, 0), 2)
    canvas.polygon(
        [(flag_x, flag_y - 50), (flag_x + 25, flag_y - 45), (flag_x, flag_y - 40)],
        (204, 204, 0),
    )
    return canvas.rgb_array()


class MountainCarEnv(gym.Env[np.ndarray, int]):
    """Under-powered car that must build momentum to reach the goal."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(self, render_mode: str | None = None, goal_velocity: float = 0):
        self.params = MountainCarParams(goal_velocity=goal_velocity)
        self.min_position = self.params.min_position
        self.max_position = self.params.max_position
        self.max_speed = self.params.max_speed
        self.goal_position = self.params.goal_position
        self.goal_velocity = goal_velocity
        self.force = self.params.force
        self.gravity = self.params.gravity

        self.low = np.array([self.min_position, -self.max_speed], dtype=np.float32)
        self.high = np.array([self.max_position, self.max_speed], dtype=np.float32)

        self.render_mode = render_mode
        self._display = None

        self.action_space = spaces.Discrete(3)
        self.observation_space = spaces.Box(self.low, self.high, dtype=np.float32)

        self.state: np.ndarray | None = None

    def step(self, action: int):
        assert self.action_space.contains(action), f"{action!r} ({type(action)}) invalid"

        push = (action - 1) * self.force
        # Internal state stays float64 (parity with the reference); only the
        # returned observation narrows to float32.
        self.state = integrate(np, self.state, push, self.params)
        terminated = bool(is_goal(np, self.state, self.params))
        reward = -1.0

        if self.render_mode == "human":
            self.render()
        return np.array(self.state, dtype=np.float32), reward, terminated, False, {}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        low, high = maybe_parse_reset_bounds(options, -0.6, -0.4)
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
        frame = _render_mountain_car(self.state, self.params)
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(600, 400, self.metadata["render_fps"], "MountainCar")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None
