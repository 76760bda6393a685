"""Pendulum as a batch-first functional env.

Counterpart of ``PendulumFunctional`` in the JAX package's
``envs/phys2d/pendulum.py``, over the port's own copy of the dynamics. State
is the raw ``[θ, θ']`` tensor with a leading env axis. Rendering and the
stateful adapters are not ported.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.pendulum import PendulumParams, cost, integrate, observe
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["PendulumFunctional", "PendulumParams"]


class PendulumFunctional(FuncEnv):
    """Stateless pendulum; only the reset draws randomness."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        params = self.get_default_params()
        high = np.array([1.0, 1.0, params.max_speed], dtype=np.float32)
        self.observation_space = spaces.Box(-high, high, dtype=np.float32)
        self.action_space = spaces.Box(-params.max_torque, params.max_torque, shape=(1,), dtype=np.float32)

    def get_default_params(self, **kwargs: Any) -> PendulumParams:
        return PendulumParams(**kwargs)

    def reset_values(self, u: torch.Tensor, params: PendulumParams | None = None) -> torch.Tensor:
        """The reset state of U[0, 1) draws ``u`` (N, 2): θ in
        ``[-reset_x, reset_x)``, θ' in ``[-reset_y, reset_y)``."""
        p = params or PendulumParams()
        return torch.stack(
            (uniform_map(u[:, 0], -p.reset_x, p.reset_x), uniform_map(u[:, 1], -p.reset_y, p.reset_y)), dim=-1
        )

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n, 2)."""
        return (torch.rand((n, 2), generator=rng, device=rng.device),)

    def initial(self, rng: torch.Generator, params: PendulumParams | None = None):
        return self.initial_batched(rng, 1, params)[0]

    def initial_batched(self, rng: torch.Generator, n: int, params: PendulumParams | None = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def _torque(self, action, p: PendulumParams) -> torch.Tensor:
        return torch.clamp(action.reshape(-1).to(torch.float32), -p.max_torque, p.max_torque)

    def transition(self, state, action, rng, params: PendulumParams | None = None):
        p = params or PendulumParams()
        return integrate(torch, state, self._torque(action, p), p)

    def observation(self, state, rng, params: PendulumParams | None = None):
        return observe(torch, state).to(torch.float32)

    def reward(self, state, action, next_state, rng, params: PendulumParams | None = None):
        p = params or PendulumParams()
        return -cost(torch, state, self._torque(action, p), p).to(torch.float32)

    def terminal(self, state, rng, params: PendulumParams | None = None):
        return torch.zeros(state.shape[:-1], dtype=torch.bool, device=state.device)
