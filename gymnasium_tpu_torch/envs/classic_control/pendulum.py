"""Pendulum swing-up: the host env class (copy of the JAX package's
``envs/classic_control/pendulum.py``), on the host in numpy.

Bit-exact parity target: reference classic_control/pendulum.py:126-147.
Dynamics live in ``envs/dynamics/pendulum.py``, shared with the functional
env.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.classic_control.utils import verify_number_and_cast
from gymnasium_tpu_torch.envs.dynamics.pendulum import (
    PendulumParams,
    cost,
    integrate,
    observe,
)

DEFAULT_X = np.pi
DEFAULT_Y = 1.0


class PendulumEnv(gym.Env[np.ndarray, np.ndarray]):
    """Torque-controlled inverted pendulum swing-up."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 30}

    def __init__(self, render_mode: str | None = None, g: float = 10.0):
        self.params = PendulumParams(g=g)
        self.max_speed = self.params.max_speed
        self.max_torque = self.params.max_torque
        self.dt = self.params.dt
        self.g = g
        self.m = self.params.m
        self.l = self.params.l

        self.render_mode = render_mode
        self._display = None
        self.screen_dim = 500

        high = np.array([1.0, 1.0, self.max_speed], dtype=np.float32)
        self.action_space = spaces.Box(
            low=-self.max_torque, high=self.max_torque, shape=(1,), dtype=np.float32
        )
        self.observation_space = spaces.Box(low=-high, high=high, dtype=np.float32)

        self.state: np.ndarray | None = None
        self.last_u: float | None = None

    def step(self, u):
        u = np.clip(u, -self.max_torque, self.max_torque)[0]
        self.last_u = u  # for rendering
        costs = float(cost(np, self.state, u, self.params))
        self.state = integrate(np, self.state, u, self.params)

        if self.render_mode == "human":
            self.render()
        return self._get_obs(), -costs, False, False, {}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if options is None:
            high = np.array([DEFAULT_X, DEFAULT_Y])
        else:
            x = options.get("x_init") if "x_init" in options else DEFAULT_X
            y = options.get("y_init") if "y_init" in options else DEFAULT_Y
            x = verify_number_and_cast(x)
            y = verify_number_and_cast(y)
            high = np.array([x, y])
        low = -high
        self.state = self.np_random.uniform(low=low, high=high)
        self.last_u = None

        if self.render_mode == "human":
            self.render()
        return self._get_obs(), {}

    def _get_obs(self):
        return observe(np, self.state).astype(np.float32)

    def render(self):
        if self.render_mode is None:
            gym.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return None
        from gymnasium_tpu_torch.utils.raster import Canvas

        dim = self.screen_dim
        canvas = Canvas(dim, dim)
        cx = cy = dim / 2
        scale = dim / 4.4  # world is 2.2 units wide
        theta = float(self.state[0])
        rod_len = 1.0 * scale
        # The rod points up at theta=0 (screen y grows downward).
        tipx = cx + rod_len * math.sin(theta)
        tipy = cy - rod_len * math.cos(theta)
        canvas.line((cx, cy), (tipx, tipy), (204, 77, 77), 0.2 * scale)
        canvas.circle((cx, cy), 0.05 * scale, (0, 0, 0))
        canvas.circle((tipx, tipy), 0.1 * scale, (204, 77, 77))
        frame = canvas.rgb_array()

        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(dim, dim, self.metadata["render_fps"], "Pendulum")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None


def angle_normalize(x):
    """Map an angle into [-pi, pi) (reference pendulum.py:282)."""
    return ((x + np.pi) % (2 * np.pi)) - np.pi
