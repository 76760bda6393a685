"""CartPole: the host env class and the natively batched numpy vector env.

Counterpart of the JAX package's ``envs/classic_control/cartpole.py``, which
is plain numpy in float64: the same code over the port's ``Env``,
``VectorEnv``, spaces and canvas. Behavioral parity targets (bit-exact under
fixed seed):
- reference gymnasium/envs/classic_control/cartpole.py:163-225 (CartPoleEnv)
- reference gymnasium/envs/classic_control/cartpole.py:355-605 (CartPoleVectorEnv)

The physics lives in ``envs/dynamics/cartpole.py``, shared with the
functional env (``envs/phys2d/cartpole.py``) that ``make_vec`` runs on the
card. These classes run on the host and take no device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.logger as logger
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.classic_control.utils import maybe_parse_reset_bounds
from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams, integrate, is_terminated
from gymnasium_tpu_torch.vector import AutoresetMode, VectorEnv
from gymnasium_tpu_torch.vector.utils import batch_space


def _obs_space(params: CartPoleParams) -> spaces.Box:
    high = np.array(
        [
            params.x_threshold * 2,
            np.inf,
            params.theta_threshold * 2,
            np.inf,
        ],
        dtype=np.float32,
    )
    return spaces.Box(-high, high, dtype=np.float32)


def _render_cartpole(state: np.ndarray, params: CartPoleParams, width=600, height=400) -> np.ndarray:
    """Rasterize a cart-pole frame from state (no pygame on this path)."""
    from gymnasium_tpu_torch.utils.raster import Canvas

    canvas = Canvas(width, height)
    world_width = params.x_threshold * 2
    scale = width / world_width
    polewidth, polelen = 10.0, scale * (2 * params.length)
    cartwidth, cartheight = 50.0, 30.0

    x, _, theta, _ = (float(v) for v in state)
    cartx = x * scale + width / 2.0
    carty_top = height - 100 - cartheight / 2

    canvas.hline(height - 100, (0, 0, 0))
    canvas.polygon(
        [
            (cartx - cartwidth / 2, carty_top),
            (cartx + cartwidth / 2, carty_top),
            (cartx + cartwidth / 2, carty_top + cartheight),
            (cartx - cartwidth / 2, carty_top + cartheight),
        ],
        (0, 0, 0),
    )
    axle_y = height - 100 - cartheight / 4
    tipx = cartx + polelen * math.sin(theta)
    tipy = axle_y - polelen * math.cos(theta)
    canvas.line((cartx, axle_y), (tipx, tipy), (202, 152, 101), polewidth)
    canvas.circle((cartx, axle_y), polewidth / 2, (129, 132, 203))
    return canvas.rgb_array()


class CartPoleEnv(gym.Env[np.ndarray, int]):
    """Classic cart-pole balancing task (Barto, Sutton & Anderson)."""

    metadata = {
        "render_modes": ["human", "rgb_array"],
        "render_fps": 50,
        "autoreset_mode": AutoresetMode.NEXT_STEP,
    }

    def __init__(self, sutton_barto_reward: bool = False, render_mode: str | None = None):
        self._sutton_barto_reward = sutton_barto_reward
        self.params = CartPoleParams()
        self.kinematics_integrator = "euler"

        # Kept as attributes for reference-API compatibility.
        self.gravity = self.params.gravity
        self.masscart = self.params.masscart
        self.masspole = self.params.masspole
        self.total_mass = self.masspole + self.masscart
        self.length = self.params.length
        self.polemass_length = self.masspole * self.length
        self.force_mag = self.params.force_mag
        self.tau = self.params.tau
        self.theta_threshold_radians = self.params.theta_threshold
        self.x_threshold = self.params.x_threshold

        self.action_space = spaces.Discrete(2)
        self.observation_space = _obs_space(self.params)

        self.render_mode = render_mode
        self._display = None

        self.state: np.ndarray | None = None
        self.steps_beyond_terminated: int | None = None

    def step(self, action):
        assert self.action_space.contains(action), f"{action!r} ({type(action)}) invalid"
        assert self.state is not None, "Call reset before using step method."

        force = self.force_mag if action == 1 else -self.force_mag
        self.state = integrate(
            np, self.state, force, self.params, euler=self.kinematics_integrator == "euler"
        )
        terminated = bool(is_terminated(np, self.state, self.params))

        if not terminated:
            reward = 0.0 if self._sutton_barto_reward else 1.0
        elif self.steps_beyond_terminated is None:
            # Pole just fell.
            self.steps_beyond_terminated = 0
            reward = -1.0 if self._sutton_barto_reward else 1.0
        else:
            if self.steps_beyond_terminated == 0:
                logger.warn(
                    "You are calling 'step()' even though this environment has already "
                    "returned terminated = True. You should always call 'reset()' once "
                    "terminated = True -- any further steps are undefined behavior."
                )
            self.steps_beyond_terminated += 1
            reward = -1.0 if self._sutton_barto_reward else 0.0

        if self.render_mode == "human":
            self.render()
        return np.array(self.state, dtype=np.float32), reward, terminated, False, {}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        low, high = maybe_parse_reset_bounds(options, -0.05, 0.05)
        self.state = self.np_random.uniform(low=low, high=high, size=(4,))
        self.steps_beyond_terminated = None
        if self.render_mode == "human":
            self.render()
        return np.array(self.state, dtype=np.float32), {}

    def render(self):
        if self.render_mode is None:
            logger.warn(
                "You are calling render method without specifying any render mode. "
                "You can specify the render_mode at initialization."
            )
            return None
        # pre-reset render is a no-op (reference cartpole.py:285-286)
        if self.state is None:
            return None
        frame = _render_cartpole(self.state, self.params)
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(600, 400, self.metadata["render_fps"], "CartPole")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None


class CartPoleVectorEnv(VectorEnv):
    """Natively batched numpy CartPole (reference cartpole.py:355-605).

    Whole-batch array stepping with internal next-step autoreset and
    time-limit truncation; registered as the ``vector_entry_point``.
    """

    metadata = {
        "render_modes": ["rgb_array"],
        "render_fps": 50,
        "autoreset_mode": AutoresetMode.NEXT_STEP,
    }

    def __init__(
        self,
        num_envs: int = 1,
        max_episode_steps: int = 500,
        sutton_barto_reward: bool = False,
        render_mode: str | None = None,
    ):
        self._sutton_barto_reward = sutton_barto_reward
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.render_mode = render_mode
        self.params = CartPoleParams()

        self.state = np.zeros((num_envs, 4), dtype=np.float64)
        self.steps = np.zeros(num_envs, dtype=np.int32)
        self.prev_done = np.zeros(num_envs, dtype=np.bool_)

        self.single_action_space = spaces.Discrete(2)
        self.action_space = batch_space(self.single_action_space, num_envs)
        self.single_observation_space = _obs_space(self.params)
        self.observation_space = batch_space(self.single_observation_space, num_envs)

        self.low = -0.05
        self.high = 0.05

    def step(self, action):
        assert self.state is not None, "Call reset before using step method."
        action = np.asarray(action)

        force = np.where(action == 1, self.params.force_mag, -self.params.force_mag)
        self.state = integrate(np, self.state, force, self.params, euler=True)

        terminated = is_terminated(np, self.state, self.params)
        self.steps += 1
        truncated = self.steps >= self.max_episode_steps

        if self._sutton_barto_reward:
            reward = np.where(terminated, -1.0, 0.0)
        else:
            reward = np.ones(self.num_envs, dtype=np.float64)

        # Next-step autoreset: envs that finished *last* step restart now.
        if self.prev_done.any():
            to_reset = self.prev_done
            n_reset = int(to_reset.sum())
            self.state[to_reset] = self.np_random.uniform(
                low=self.low, high=self.high, size=(n_reset, 4)
            )
            self.steps[to_reset] = 0
            reward[to_reset] = 0.0
            terminated[to_reset] = False
            truncated[to_reset] = False

        self.prev_done = np.logical_or(terminated, truncated)
        obs = self.state.astype(np.float32)
        return obs, reward, terminated, truncated, {}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        low, high = maybe_parse_reset_bounds(options, -0.05, 0.05)
        self.low, self.high = low, high
        self.state = self.np_random.uniform(low=low, high=high, size=(self.num_envs, 4))
        self.steps = np.zeros(self.num_envs, dtype=np.int32)
        self.prev_done = np.zeros(self.num_envs, dtype=np.bool_)
        return self.state.astype(np.float32), {}

    def render(self):
        # any non-None mode renders per-env frames (reference
        # cartpole.py:507-598: the vector env draws for every mode incl.
        # "rgb_array_list"; HumanRendering peels the list form)
        if self.render_mode is None:
            import gymnasium_tpu_torch as gym

            gym.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return None
        frames = tuple(_render_cartpole(s, self.params) for s in self.state)
        if self.render_mode.endswith("_list"):
            return tuple([f] for f in frames)
        return frames
