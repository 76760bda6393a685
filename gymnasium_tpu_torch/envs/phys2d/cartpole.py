"""CartPole as a batch-first functional env.

Counterpart of ``CartPoleFunctional`` in the JAX package's
``envs/phys2d/cartpole.py``, over the port's own copy of the shared dynamics.
State is the raw ``[x, x', θ, θ']`` tensor with a leading env axis; reset
draws come from the ``torch.Generator`` passed in, on its device.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams, integrate, is_terminated
from gymnasium_tpu_torch.functional import FuncEnv

__all__ = ["CartPoleFunctional", "CartPoleParams"]


def reset_values(u: torch.Tensor, params: CartPoleParams) -> torch.Tensor:
    """Map U[0, 1) draws to the reset interval ``[-reset_bound, reset_bound)``.

    The fused rollout kernel applies the same map, so a reset state depends
    only on its draws.
    """
    return (u * 2.0 - 1.0) * params.reset_bound


class CartPoleFunctional(FuncEnv):
    """Stateless CartPole; only the reset draws randomness."""

    def __init__(self, options: dict[str, Any] | None = None):
        super().__init__(options)
        params = self.get_default_params()
        high = np.array(
            [params.x_threshold * 2, np.inf, params.theta_threshold * 2, np.inf],
            dtype=np.float32,
        )
        self.observation_space = spaces.Box(-high, high, dtype=np.float32)
        self.action_space = spaces.Discrete(2)

    def get_default_params(self, **kwargs: Any) -> CartPoleParams:
        return CartPoleParams(**kwargs)

    def initial(self, rng: torch.Generator, params: CartPoleParams | None = None):
        return self.initial_batched(rng, 1, params)[0]

    def initial_batched(self, rng: torch.Generator, n: int, params: CartPoleParams | None = None):
        u = torch.rand((n, 4), generator=rng, device=rng.device)
        return reset_values(u, params or CartPoleParams())

    def transition(self, state, action, rng, params: CartPoleParams | None = None):
        params = params or CartPoleParams()
        force = torch.where(action == 1, params.force_mag, -params.force_mag).to(state.dtype)
        return integrate(torch, state, force, params, euler=True)

    def observation(self, state, rng, params: CartPoleParams | None = None):
        return state.to(torch.float32)

    def reward(self, state, action, next_state, rng, params: CartPoleParams | None = None):
        return torch.ones(next_state.shape[:-1], dtype=torch.float32, device=next_state.device)

    def terminal(self, state, rng, params: CartPoleParams | None = None):
        return is_terminated(torch, state, params or CartPoleParams())
