"""CartPole as a batch-first functional env.

Counterpart of ``CartPoleFunctional`` in the JAX package's
``envs/phys2d/cartpole.py``, over the port's own copy of the shared dynamics.
State is the raw ``[x, x', θ, θ']`` tensor with a leading env axis; reset
draws come from the ``torch.Generator`` passed in, on its device. The render
hooks draw one state on the host, and :class:`CartPoleTorchEnv` and
:class:`CartPoleTorchVectorEnv` are the named adapters of JAX's
``CartPoleJaxEnv`` and ``CartPoleJaxVectorEnv``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.cartpole import CartPoleParams, integrate, is_terminated
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["CartPoleFunctional", "CartPoleParams", "CartPoleTorchEnv", "CartPoleTorchVectorEnv"]


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

    # -- host-side rendering ----------------------------------------------

    def render_init(self, screen_width: int = 600, screen_height: int = 400):
        return (screen_width, screen_height)

    def render_image(self, state, render_state, params: CartPoleParams | None = None):
        from gymnasium_tpu_torch.envs.classic_control.cartpole import _render_cartpole

        width, height = render_state
        return render_state, _render_cartpole(to_host(state), params or CartPoleParams(), width, height)

    def render_close(self, render_state) -> None:
        pass


from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv  # noqa: E402
from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv  # noqa: E402


class CartPoleTorchEnv(FunctionalTorchEnv):
    """Stateful CartPole on ``device`` (JAX's ``CartPoleJaxEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50, "torch": True}

    def __init__(self, render_mode: str | None = None, device: str | torch.device | None = None, **kwargs: Any):
        super().__init__(
            CartPoleFunctional(kwargs or None),
            metadata=self.metadata,
            render_mode=render_mode,
            device=device,
        )


class CartPoleTorchVectorEnv(TorchVectorEnv):
    """Vectorized CartPole on ``device`` (JAX's ``CartPoleJaxVectorEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50, "torch": True}

    def __init__(
        self,
        num_envs: int,
        render_mode: str | None = None,
        max_episode_steps: int = 200,
        device: str | torch.device | None = None,
        **kwargs: Any,
    ):
        super().__init__(
            CartPoleFunctional(kwargs or None),
            num_envs=num_envs,
            max_episode_steps=max_episode_steps,
            device=device,
        )
