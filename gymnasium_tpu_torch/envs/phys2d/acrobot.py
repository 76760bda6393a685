"""Acrobot as a batch-first functional env.

Counterpart of ``AcrobotFunctional`` in the JAX package's
``envs/phys2d/acrobot.py``, over the port's own copy of the dynamics. State
is the raw ``[θ1, θ2, θ1', θ2']`` tensor with a leading env axis; only the
reset draws randomness.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.acrobot import AcrobotParams, integrate, is_terminated, observe
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["AcrobotFunctional", "AcrobotParams"]


class AcrobotFunctional(FuncEnv):
    """Stateless acrobot; actions 0, 1, 2 apply torques -1, 0, +1."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        params = self.get_default_params()
        high = np.array([1.0, 1.0, 1.0, 1.0, params.max_vel_1, params.max_vel_2], dtype=np.float32)
        self.observation_space = spaces.Box(-high, high, dtype=np.float32)
        self.action_space = spaces.Discrete(3)

    def get_default_params(self, **kwargs: Any) -> AcrobotParams:
        return AcrobotParams(**kwargs)

    def reset_values(self, u: torch.Tensor, params: AcrobotParams | None = None) -> torch.Tensor:
        """The reset state of U[0, 1) draws ``u`` (N, 4), each value in
        ``[-reset_bound, reset_bound)``."""
        p = params or AcrobotParams()
        return uniform_map(u, -p.reset_bound, p.reset_bound)

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n, 4)."""
        return (torch.rand((n, 4), generator=rng, device=rng.device),)

    def initial(self, rng: torch.Generator, params: AcrobotParams | None = None):
        return self.initial_batched(rng, 1, params)[0]

    def initial_batched(self, rng: torch.Generator, n: int, params: AcrobotParams | None = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def transition(self, state, action, rng, params: AcrobotParams | None = None):
        torque = (action - 1).to(torch.float32)
        return integrate(torch, state, torque, params or AcrobotParams())

    def observation(self, state, rng, params: AcrobotParams | None = None):
        return observe(torch, state).to(torch.float32)

    def reward(self, state, action, next_state, rng, params: AcrobotParams | None = None):
        return torch.where(is_terminated(torch, next_state), 0.0, -1.0)

    def terminal(self, state, rng, params: AcrobotParams | None = None):
        return is_terminated(torch, state)
