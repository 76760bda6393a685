"""LunarLander-v3: the host env class behind ``make(id)``, and the
batch-first functional env.

Counterpart of the JAX package's ``envs/box2d/lunar_lander.py``, over the
port's own copy of the dynamics.

:class:`LunarLander` keeps the JAX class's host API: a numpy float32
observation, a Python float reward and a bool ``terminated``, with every
random draw taken from ``np_random`` in the JAX class's calls and order (the
reference's deterministic-chaos wind is walked on the host in float64). Its
physics runs on the env's device, CUDA unless the caller passes
``device="cpu"``: a reset uploads its draws as one row and makes one call of
the fused planar step (the settle tick), a step uploads the action,
dispersion and wind as one row and makes one call (both substeps), each a
launch of the lander build on the card and the plain twin on the CPU. Each
reads back one packed row. ``heuristic`` and ``demo_heuristic_lander`` are
the JAX module's controller and its episode loop.

The functionals run both solver calls of the JAX functional through the same
fused step (:func:`~gymnasium_tpu_torch.envs.dynamics.lunar_lander.lander_step`):
the transition, and the reference's settle tick inside every reset. The
autoreset step draws a reset for the whole batch each step; its
``autoreset_transition`` makes one call of the fused step for both, on
inputs chosen lane by lane, so an env step launches the kernel once on the
card.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import error, logger, spaces
from gymnasium_tpu_torch.core import Env
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.functional import FuncEnv, deferred_ticks, tree_map
from gymnasium_tpu_torch.utils.device import resolve_device, upload_row
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = [
    "LunarLander",
    "LunarLanderContinuous",
    "LunarLanderFunctional",
    "LunarLanderContinuousFunctional",
    "heuristic",
    "demo_heuristic_lander",
]

_OBS_LOW = np.array([-2.5, -2.5, -10.0, -10.0, -2 * math.pi, -10.0, -0.0, -0.0], dtype=np.float32)
_OBS_HIGH = np.array([2.5, 2.5, 10.0, 10.0, 2 * math.pi, 10.0, 1.0, 1.0], dtype=np.float32)


def _wind_terms(np_random, wind_idx, torque_idx, params, enabled: bool):
    """The reference's deterministic-chaos wind model (lunar_lander.py:470):
    ``([wind, torque], wind_idx + 1, torque_idx + 1)`` in float64, or zeros
    and the indices as they are when wind is off."""
    if not enabled:
        return np.zeros(2), wind_idx, torque_idx
    wind_mag = (
        math.tanh(math.sin(0.02 * wind_idx) + math.sin(math.pi * 0.01 * wind_idx))
        * params.wind_power
    )
    torque_mag = (
        math.tanh(math.sin(0.02 * torque_idx) + math.sin(math.pi * 0.01 * torque_idx))
        * params.turbulence_power
    )
    return np.array([wind_mag, torque_mag]), wind_idx + 1, torque_idx + 1


class LunarLander(Env[np.ndarray, Any], EzPickle):
    """Rocket trajectory optimization onto the landing pad.

    ``device`` is where the physics runs: ``None`` means CUDA, and without a
    card that raises (:func:`~gymnasium_tpu_torch.utils.device.resolve_device`);
    ``"cpu"`` runs the plain twin. ``state`` holds the JAX class's keys and
    shapes, the batch axis of one included, as float32 and bool tensors on
    that device.
    """

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": dyn.FPS}

    def __init__(
        self,
        render_mode: str | None = None,
        continuous: bool = False,
        gravity: float = -10.0,
        enable_wind: bool = False,
        wind_power: float = 15.0,
        turbulence_power: float = 1.5,
        device: str | torch.device | None = None,
    ):
        EzPickle.__init__(
            self,
            render_mode,
            continuous,
            gravity,
            enable_wind,
            wind_power,
            turbulence_power,
            device=device,
        )
        assert -12.0 < gravity and gravity < 0.0, f"gravity (current value: {gravity}) must be between -12 and 0"
        if 0.0 > wind_power or wind_power > 20.0:
            logger.warn(f"wind_power value is recommended to be between 0.0 and 20.0, (current value: {wind_power})")
        if 0.0 > turbulence_power or turbulence_power > 2.0:
            logger.warn(f"turbulence_power value is recommended to be between 0.0 and 2.0, (current value: {turbulence_power})")

        self.device = resolve_device(device)
        self.continuous = continuous
        self.gravity = gravity
        self.enable_wind = enable_wind
        self.params = dyn.LunarParams(
            gravity=gravity, wind_power=wind_power, turbulence_power=turbulence_power
        )
        self._func = LunarLanderFunctional({"gravity": gravity})
        self.render_mode = render_mode
        self._display = None

        self.observation_space = spaces.Box(_OBS_LOW, _OBS_HIGH, dtype=np.float32)
        if self.continuous:
            self.action_space = spaces.Box(-1, +1, (2,), dtype=np.float32)
        else:
            self.action_space = spaces.Discrete(4)

        self.state: dict | None = None
        self.wind_idx = 0
        self.torque_idx = 0

    def _read_back(self) -> np.ndarray:
        """The observation, reward and termination of ``state`` as one float32
        row on the host: one copy."""
        s = self.state
        obs = dyn.observe(s["body"], s["leg1"], s["leg2"])
        row = torch.cat([obs, s["r"][:, None], s["done"][:, None].to(torch.float32)], dim=-1)
        return row[0].cpu().numpy()

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        terrain_u = self.np_random.uniform(0, 1, size=(dyn.CHUNKS + 1,))
        force_u = self.np_random.uniform(-1, 1, size=(2,))
        draws = upload_row(self.device, terrain_u, force_u)
        self.state = self._func.reset_values(draws[:, : dyn.CHUNKS + 1], draws[:, dyn.CHUNKS + 1 :], self.params)
        self.wind_idx = int(self.np_random.integers(-9999, 9999))
        self.torque_idx = int(self.np_random.integers(-9999, 9999))

        obs = self._read_back()[:8]
        if self.render_mode == "human":
            self.render()
        return obs, {}

    def step(self, action):
        assert self.state is not None, "You forgot to call reset()"
        if self.continuous:
            action = np.clip(np.asarray(action, dtype=np.float64), -1, +1)
        else:
            assert self.action_space.contains(action), f"{action!r} ({type(action)}) invalid "
            action = np.asarray([action])

        dispersion = self.np_random.uniform(-1.0, 1.0, size=(1, 2))
        wind, self.wind_idx, self.torque_idx = _wind_terms(
            self.np_random, self.wind_idx, self.torque_idx, self.params, self.enable_wind
        )
        row = upload_row(self.device, action, dispersion, wind)
        k = row.shape[1] - 4
        # a discrete action travels as a float: the engine map compares it with 1, 2 and 3
        action_t = row[:, :k] if self.continuous else row[:, 0]
        self.state = dyn.full_step(
            self.state, action_t, row[:, k : k + 2], row[:, k + 2 :], self.params, self.continuous
        )
        out = self._read_back()
        obs = out[:8]
        reward = float(out[8])
        terminated = bool(out[9])
        if self.render_mode == "human":
            self.render()
        return obs, reward, terminated, False, {}

    def render(self):
        if self.render_mode is None:
            logger.warn("You are calling render method without specifying any render mode.")
            return None
        frame = _render_lander(self.state, self.params)
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(
                    dyn.VIEWPORT_W, dyn.VIEWPORT_H, self.metadata["render_fps"], "LunarLander"
                )
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None


def _render_lander(state, params, width=dyn.VIEWPORT_W, height=dyn.VIEWPORT_H):
    """Rasterize terrain + lander; the state is read to the host here."""
    from gymnasium_tpu_torch.utils.raster import Canvas

    canvas = Canvas(width, height, (0, 0, 0))
    scale = dyn.SCALE
    terrain = state["terrain"][0].cpu().numpy()
    xs = np.linspace(0, dyn.W, dyn.CHUNKS)
    pts = [(x * scale, height - h * scale) for x, h in zip(xs, terrain)]
    ground = pts + [(width, height), (0, height)]
    canvas.polygon(ground, (255, 255, 255))

    bodies = state["body"][0].cpu().numpy()
    hx, hy, angle = bodies[0, 0], bodies[0, 1], bodies[0, 2]
    c, s = math.cos(angle), math.sin(angle)
    # hull vertices are origin-relative; the state row carries the hull COM
    x, y = hx + dyn._HULL_CY * s, hy - dyn._HULL_CY * c
    poly = []
    for bx, by in dyn.LANDER_POLY:
        bx, by = bx / scale, by / scale
        rx = bx * c - by * s
        ry = bx * s + by * c
        poly.append(((x + rx) * scale, height - (y + ry) * scale))
    canvas.polygon(poly, (128, 102, 230))
    for leg in bodies[1:]:
        lx, ly, la = leg[0], leg[1], leg[2]
        lc, ls = math.cos(la), math.sin(la)
        corners = []
        for bx, by in [(-dyn._LEG_HALF_W, -dyn._LEG_HALF_H), (dyn._LEG_HALF_W, -dyn._LEG_HALF_H),
                       (dyn._LEG_HALF_W, dyn._LEG_HALF_H), (-dyn._LEG_HALF_W, dyn._LEG_HALF_H)]:
            rx = bx * lc - by * ls
            ry = bx * ls + by * lc
            corners.append(((lx + rx) * scale, height - (ly + ry) * scale))
        canvas.polygon(corners, (77, 77, 128))
    return canvas.rgb_array()


class LunarLanderFunctional(FuncEnv):
    """Stateless LunarLander (discrete actions: noop, left, main, right).

    State: a dict of ``body`` (N, 3, 6), ``terrain`` (N, 11), ``jimp`` (N, 2, 5),
    ``cimp`` (N, 10, 2), ``sleep_timer``, ``prev_shaping`` and ``r`` (N,) in
    float32, and ``leg1``, ``leg2``, ``done`` (N,) bool. Options: ``gravity``,
    ``enable_wind``, ``wind_power``, ``turbulence_power``, ``continuous``.
    """

    continuous = False

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        gravity = options.pop("gravity", -10.0)
        self.enable_wind = bool(options.pop("enable_wind", False))
        wind_power = options.pop("wind_power", 15.0)
        turbulence_power = options.pop("turbulence_power", 1.5)
        if "continuous" in options:
            self.continuous = bool(options.pop("continuous"))
        super().__init__(options)
        self._default_params = dyn.LunarParams(
            gravity=gravity, wind_power=wind_power, turbulence_power=turbulence_power
        )

        self.observation_space = spaces.Box(_OBS_LOW, _OBS_HIGH, dtype=np.float32)
        if self.continuous:
            self.action_space = spaces.Box(-1, +1, (2,), dtype=np.float32)
        else:
            self.action_space = spaces.Discrete(4)

    def get_default_params(self, **kwargs: Any) -> dyn.LunarParams:
        return self._default_params._replace(**kwargs)

    def reset_values(self, terrain_u, force_u, params: dyn.LunarParams | None = None) -> dict:
        """The reset state of draws ``terrain_u ~ U[0, 1)`` (N, CHUNKS + 1) and
        ``force_u ~ U[-1, 1)`` (N, 2): the creation pose, then the
        reference's settle tick through the fused step with no external force
        and no engine power, as the JAX ``initial_batched`` does."""
        p = params or self._default_params
        state = dyn.initial_state_pre(terrain_u, force_u, p)
        external = torch.zeros(terrain_u.shape[:-1] + (3, 3), dtype=torch.float32, device=terrain_u.device)
        return dyn.tick(state, external, 0.0, 0.0, p)

    def initial(self, rng: torch.Generator, params: dyn.LunarParams | None = None):
        return tree_map(lambda x: x[0], self.initial_batched(rng, 1, params))

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: ``terrain_u`` (n, CHUNKS + 1) and ``force_u`` (n, 2)."""
        terrain_u = torch.rand((n, dyn.CHUNKS + 1), generator=rng, device=rng.device)
        # jax.random.uniform(minval=-1, maxval=1) is u * (max - min) + min
        force_u = torch.rand((n, 2), generator=rng, device=rng.device) * 2.0 - 1.0
        return terrain_u, force_u

    def initial_batched(self, rng: torch.Generator, n: int, params: dyn.LunarParams | None = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def transition_values(self, state, action, dispersion, wind=None, params: dyn.LunarParams | None = None):
        """The transition for given draws: ``dispersion ~ U[-1, 1)`` (N, 2)
        and, with wind enabled, ``wind ~ U[-1, 1)`` (N, 2), scaled here by
        the wind and turbulence powers (the functional's stochastic stand-in
        for the reference's chaotic index walk)."""
        p = params or self._default_params
        if self.enable_wind:
            powers = torch.tensor([p.wind_power, p.turbulence_power], dtype=torch.float32, device=wind.device)
            wind = wind * powers
        else:
            wind = torch.zeros_like(dispersion)
        if self.continuous:
            action = torch.clamp(action.to(torch.float32), -1.0, 1.0)
        return dyn.full_step(state, action, dispersion, wind, p, self.continuous)

    def transition_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` transitions: ``dispersion`` (n, 2) and, with
        wind enabled, ``wind`` (n, 2), else None."""
        dispersion = torch.rand((n, 2), generator=rng, device=rng.device) * 2.0 - 1.0
        wind = None
        if self.enable_wind:
            wind = torch.rand((n, 2), generator=rng, device=rng.device) * 2.0 - 1.0
        return dispersion, wind

    def transition(self, state, action, rng: torch.Generator, params: dyn.LunarParams | None = None):
        return self.transition_values(state, action, *self.transition_draws(rng, state["body"].shape[0]), params)

    def autoreset_transition(self, state, action, prev_done, rng: torch.Generator,
                             params: dyn.LunarParams | None = None) -> dict:
        """An autoreset step of the batch that ``vectorize_func_env`` made, in
        one call of the fused step: the transition and the batch's
        ``initial``, their draws taken in ``make_autoreset_step``'s order,
        each solver call left unmade, then both made as one
        (:func:`~gymnasium_tpu_torch.envs.dynamics.lunar_lander.autoreset_tick`)."""
        with deferred_ticks():
            moved = self.transition(state, action, rng, params)
            reset = self.initial(rng, params)
        return dyn.autoreset_tick(prev_done, reset, moved)

    def observation(self, state, rng, params: dyn.LunarParams | None = None):
        return dyn.observe(state["body"], state["leg1"], state["leg2"]).to(torch.float32)

    def reward(self, state, action, next_state, rng, params: dyn.LunarParams | None = None):
        return next_state["r"]

    def terminal(self, state, rng, params: dyn.LunarParams | None = None):
        return state["done"]


class LunarLanderContinuousFunctional(LunarLanderFunctional):
    """Continuous-action LunarLander: ``[main, lateral]`` in [-1, 1]^2."""

    continuous = True


class LunarLanderContinuous:
    """Construction guard (reference box2d/lunar_lander.py:872-879): the
    continuous variant is made via ``gym.make("LunarLander-v3", continuous=True)``."""

    def __init__(self):
        raise error.Error(
            "Error initializing LunarLanderContinuous Environment.\n"
            "Currently, we do not support initializing this mode of environment by calling the class directly.\n"
            "To use this environment, instead create it by specifying the continuous keyword in gym.make, i.e.\n"
            'gym.make("LunarLander-v3", continuous=True)'
        )


def heuristic(env, s):
    """PD landing controller over the 8-dim lander state — the published
    Gym/Gymnasium demonstration control law (role of reference
    lunar_lander.py:793), gains tuned for this engine's dynamics.

    Steers the target attitude toward the pad from horizontal offset and
    speed, holds a descent profile proportional to the offset, and after leg
    contact only brakes the vertical speed.
    """
    angle_target = float(np.clip(0.5 * s[0] + 1.0 * s[2], -0.4, 0.4))
    hover_target = 0.55 * abs(float(s[0]))

    angle_cmd = (angle_target - float(s[4])) * 0.5 - float(s[5]) * 1.0
    hover_cmd = (hover_target - float(s[1])) * 0.5 - float(s[3]) * 0.5
    if s[6] or s[7]:  # a leg touched down: just kill vertical speed
        angle_cmd = 0.0
        hover_cmd = -float(s[3]) * 0.5

    if env.unwrapped.continuous:
        return np.clip(
            np.array([hover_cmd * 20 - 1, -angle_cmd * 20]), -1.0, 1.0
        ).astype(np.float32)
    if hover_cmd > abs(angle_cmd) and hover_cmd > 0.05:
        return 2  # main engine
    if angle_cmd < -0.05:
        return 3  # right engine
    if angle_cmd > 0.05:
        return 1  # left engine
    return 0


def demo_heuristic_lander(env, seed=None, render=False):
    """Roll one episode under :func:`heuristic`; returns the total reward
    (role of reference lunar_lander.py:755)."""
    total_reward = 0.0
    s, _ = env.reset(seed=seed)
    while True:
        s, r, terminated, truncated, _ = env.step(heuristic(env, s))
        total_reward += float(r)
        if render:
            env.render()
        if terminated or truncated:
            break
    if render:
        env.close()
    return total_reward
