"""LunarLander-v3 as a batch-first functional env.

Counterpart of ``LunarLanderFunctional`` and ``LunarLanderContinuousFunctional``
in the JAX package's ``envs/box2d/lunar_lander.py``, over the port's own copy
of the dynamics. Both solver calls of the JAX functional run through the fused
planar step (:func:`~gymnasium_tpu_torch.envs.dynamics.lunar_lander.lander_step`):
the transition, and the reference's settle tick inside every reset. The
autoreset step draws a reset for the whole batch each step, so an env step
launches the kernel twice on the card.

The host ``LunarLander`` class, its rendering and the ``heuristic`` controller
are not ported yet.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.functional import FuncEnv, tree_map

__all__ = ["LunarLanderFunctional", "LunarLanderContinuousFunctional"]


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

        low = np.array([-2.5, -2.5, -10.0, -10.0, -2 * math.pi, -10.0, -0.0, -0.0], dtype=np.float32)
        high = np.array([2.5, 2.5, 10.0, 10.0, 2 * math.pi, 10.0, 1.0, 1.0], dtype=np.float32)
        self.observation_space = spaces.Box(low, high, dtype=np.float32)
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
        bodies, jimp, cimp, flags = dyn.lander_step(float(p.gravity))(
            state["body"], external, state["terrain"], state["jimp"], state["cimp"]
        )
        return dyn.finish_step(state, bodies, (jimp, cimp), flags, 0.0, 0.0, p)

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

    def observation(self, state, rng, params: dyn.LunarParams | None = None):
        return dyn.observe(state["body"], state["leg1"], state["leg2"]).to(torch.float32)

    def reward(self, state, action, next_state, rng, params: dyn.LunarParams | None = None):
        return next_state["r"]

    def terminal(self, state, rng, params: dyn.LunarParams | None = None):
        return state["done"]


class LunarLanderContinuousFunctional(LunarLanderFunctional):
    """Continuous-action LunarLander: ``[main, lateral]`` in [-1, 1]^2."""

    continuous = True
