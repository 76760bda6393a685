"""Pendulum as a batch-first functional env.

Counterpart of ``PendulumFunctional`` in the JAX package's
``envs/phys2d/pendulum.py``, over the port's own copy of the dynamics. State
is the raw ``[θ, θ']`` tensor with a leading env axis. The render hooks draw
one state on the host, and :class:`PendulumTorchEnv` and
:class:`PendulumTorchVectorEnv` are the named adapters of JAX's
``PendulumJaxEnv`` and ``PendulumJaxVectorEnv``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.dynamics.pendulum import PendulumParams, cost, integrate, observe
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["PendulumFunctional", "PendulumParams", "PendulumTorchEnv", "PendulumTorchVectorEnv"]


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

    # -- host-side rendering ----------------------------------------------

    def render_init(self, screen_width: int = 500, screen_height: int = 500):
        return (screen_width, screen_height)

    def render_image(self, state, render_state, params: PendulumParams | None = None):
        import math

        from gymnasium_tpu_torch.utils.raster import Canvas

        width, height = render_state
        canvas = Canvas(width, height)
        cx, cy = width / 2, height / 2
        scale = width / 4.4
        theta = float(to_host(state)[0])
        tipx = cx + scale * math.sin(theta)
        tipy = cy - scale * math.cos(theta)
        canvas.line((cx, cy), (tipx, tipy), (204, 77, 77), 0.2 * scale)
        canvas.circle((tipx, tipy), 0.1 * scale, (204, 77, 77))
        return render_state, canvas.rgb_array()

    def render_close(self, render_state) -> None:
        pass


from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv  # noqa: E402
from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv  # noqa: E402


class PendulumTorchEnv(FunctionalTorchEnv):
    """Stateful Pendulum on ``device`` (JAX's ``PendulumJaxEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30, "torch": True}

    def __init__(self, render_mode: str | None = None, device: str | torch.device | None = None, **kwargs: Any):
        super().__init__(
            PendulumFunctional(kwargs or None),
            metadata=self.metadata,
            render_mode=render_mode,
            device=device,
        )


class PendulumTorchVectorEnv(TorchVectorEnv):
    """Vectorized Pendulum on ``device`` (JAX's ``PendulumJaxVectorEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 30, "torch": True}

    def __init__(
        self,
        num_envs: int,
        render_mode: str | None = None,
        max_episode_steps: int = 200,
        device: str | torch.device | None = None,
        **kwargs: Any,
    ):
        super().__init__(
            PendulumFunctional(kwargs or None),
            num_envs=num_envs,
            max_episode_steps=max_episode_steps,
            device=device,
        )
