"""Mountain car, discrete and continuous, as batch-first functional envs.

Counterpart of ``MountainCarFunctional`` and ``ContinuousMountainCarFunctional``
in the JAX package's ``envs/phys2d/mountain_car.py``, over the port's own copy
of the dynamics. State is the raw ``[position, velocity]`` tensor with a
leading env axis; only the reset draws randomness.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.mountain_car import (
    ContinuousMountainCarParams,
    MountainCarParams,
    integrate,
    is_goal,
)
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["ContinuousMountainCarFunctional", "MountainCarFunctional"]


class _MountainCarBase(FuncEnv):
    """Spaces, reset and terminal shared by both cars."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        params = self.get_default_params()
        low = np.array([params.min_position, -params.max_speed], dtype=np.float32)
        high = np.array([params.max_position, params.max_speed], dtype=np.float32)
        self.observation_space = spaces.Box(low, high, dtype=np.float32)

    def reset_values(self, u: torch.Tensor, params=None) -> torch.Tensor:
        """The reset state of U[0, 1) draws ``u`` (N,): the position in
        ``[reset_low, reset_high)``, at rest."""
        p = params or self.get_default_params()
        pos = uniform_map(u, p.reset_low, p.reset_high)
        return torch.stack((pos, torch.zeros_like(pos)), dim=-1)

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n,)."""
        return (torch.rand((n,), generator=rng, device=rng.device),)

    def initial(self, rng: torch.Generator, params=None):
        return self.initial_batched(rng, 1, params)[0]

    def initial_batched(self, rng: torch.Generator, n: int, params=None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def observation(self, state, rng, params=None):
        return state.to(torch.float32)

    def terminal(self, state, rng, params=None):
        return is_goal(torch, state, params or self.get_default_params())


class MountainCarFunctional(_MountainCarBase):
    """Stateless discrete-action mountain car (push left, none, right)."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.action_space = spaces.Discrete(3)

    def get_default_params(self, **kwargs: Any) -> MountainCarParams:
        return MountainCarParams(**kwargs)

    def transition(self, state, action, rng, params: MountainCarParams | None = None):
        p = params or MountainCarParams()
        return integrate(torch, state, (action - 1) * p.force, p)

    def reward(self, state, action, next_state, rng, params: MountainCarParams | None = None):
        return torch.full(next_state.shape[:-1], -1.0, dtype=torch.float32, device=next_state.device)


class ContinuousMountainCarFunctional(_MountainCarBase):
    """Stateless continuous-action mountain car: a force in [-1, 1]."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        params = self.get_default_params()
        self.action_space = spaces.Box(params.min_action, params.max_action, shape=(1,), dtype=np.float32)

    def get_default_params(self, **kwargs: Any) -> ContinuousMountainCarParams:
        return ContinuousMountainCarParams(**kwargs)

    def transition(self, state, action, rng, params: ContinuousMountainCarParams | None = None):
        p = params or ContinuousMountainCarParams()
        force = torch.clamp(action.reshape(-1).to(torch.float32), p.min_action, p.max_action)
        return integrate(torch, state, force * p.power, p)

    def reward(self, state, action, next_state, rng, params: ContinuousMountainCarParams | None = None):
        # the action cost takes the action unclipped, as JAX's does
        p = params or ContinuousMountainCarParams()
        a = action.reshape(-1).to(torch.float32)
        return torch.where(is_goal(torch, next_state, p), 100.0, 0.0) - 0.1 * torch.square(a)
