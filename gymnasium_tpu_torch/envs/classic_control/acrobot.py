"""Acrobot: the host env class (copy of the JAX package's
``envs/classic_control/acrobot.py``), on the host in numpy.

Bit-exact parity target: reference classic_control/acrobot.py:202-244. The
reference resets to float32 but integrates in float64 (the torque append
upcasts the RK4 state), so this step casts to float64 before the shared RK4
(``envs/dynamics/acrobot.py``), wraps the angles with its scalar
``wrap_exact`` and keeps float64 thereafter.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.classic_control.utils import maybe_parse_reset_bounds
from gymnasium_tpu_torch.envs.dynamics.acrobot import (
    AcrobotParams,
    integrate,
    is_terminated,
    observe,
    wrap_exact,
)


class AcrobotEnv(gym.Env[np.ndarray, int]):
    """Two-link underactuated pendulum that must swing its tip above the bar."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 15}

    dt = 0.2
    LINK_LENGTH_1 = 1.0
    LINK_LENGTH_2 = 1.0
    LINK_MASS_1 = 1.0
    LINK_MASS_2 = 1.0
    LINK_COM_POS_1 = 0.5
    LINK_COM_POS_2 = 0.5
    LINK_MOI = 1.0
    MAX_VEL_1 = 4 * math.pi
    MAX_VEL_2 = 9 * math.pi
    AVAIL_TORQUE = [-1.0, 0.0, +1.0]
    torque_noise_max = 0.0
    SCREEN_DIM = 500

    #: use dynamics equations from the nips paper or the book
    book_or_nips = "book"

    def __init__(self, render_mode: str | None = None):
        self.render_mode = render_mode
        self._display = None
        self.params = AcrobotParams()

        high = np.array(
            [1.0, 1.0, 1.0, 1.0, self.MAX_VEL_1, self.MAX_VEL_2], dtype=np.float32
        )
        self.observation_space = spaces.Box(low=-high, high=high, dtype=np.float32)
        self.action_space = spaces.Discrete(3)
        self.state: np.ndarray | None = None

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        low, high = maybe_parse_reset_bounds(options, -0.1, 0.1)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,)).astype(np.float32)

        if self.render_mode == "human":
            self.render()
        return self._get_ob(), {}

    def step(self, a):
        assert self.state is not None, "Call reset before using AcrobotEnv object."
        torque = self.AVAIL_TORQUE[a]

        if self.torque_noise_max > 0:
            torque += self.np_random.uniform(-self.torque_noise_max, self.torque_noise_max)

        # The torque append in the reference upcasts the RK4 state to
        # float64; reproduce by integrating in float64.
        ns = integrate(
            np,
            np.asarray(self.state, dtype=np.float64),
            torque,
            self.params,
            wrap_fn=wrap_exact,
        )
        self.state = ns
        terminated = self._terminal()
        reward = -1.0 if not terminated else 0.0

        if self.render_mode == "human":
            self.render()
        return self._get_ob(), reward, terminated, False, {}

    def _get_ob(self) -> np.ndarray:
        s = self.state
        assert s is not None, "Call reset before using AcrobotEnv object."
        return observe(np, s).astype(np.float32)

    def _terminal(self) -> bool:
        s = self.state
        assert s is not None, "Call reset before using AcrobotEnv object."
        return bool(is_terminated(np, s))

    def render(self):
        if self.render_mode is None:
            gym.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return None
        from gymnasium_tpu_torch.utils.raster import Canvas

        dim = self.SCREEN_DIM
        canvas = Canvas(dim, dim)
        bound = self.LINK_LENGTH_1 + self.LINK_LENGTH_2 + 0.2
        scale = dim / (bound * 2)
        cx = cy = dim / 2

        s = self.state
        # theta measured from the downward vertical; screen y grows down.
        p1 = (
            cx + self.LINK_LENGTH_1 * scale * math.sin(s[0]),
            cy + self.LINK_LENGTH_1 * scale * math.cos(s[0]),
        )
        p2 = (
            p1[0] + self.LINK_LENGTH_2 * scale * math.sin(s[0] + s[1]),
            p1[1] + self.LINK_LENGTH_2 * scale * math.cos(s[0] + s[1]),
        )
        canvas.hline(cy - 1 * scale, (0, 0, 0), 1)
        canvas.line((cx, cy), p1, (0, 204, 204), 0.1 * scale)
        canvas.line(p1, p2, (0, 204, 204), 0.1 * scale)
        canvas.circle((cx, cy), 0.1 * scale, (204, 204, 0))
        canvas.circle(p1, 0.1 * scale, (204, 204, 0))
        frame = canvas.rgb_array()

        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(dim, dim, self.metadata["render_fps"], "Acrobot")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None
