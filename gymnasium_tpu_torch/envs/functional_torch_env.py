"""Adapters exposing FuncEnvs through the stateful Env / VectorEnv APIs.

Counterpart of the JAX package's ``envs/functional_jax_env.py``.
:class:`FunctionalTorchEnv` steps one env on a device: the port's hooks are
batch-first, so it runs them on a batch of one and hands back the single
env's values. It carries one ``torch.Generator`` on its device where the JAX
adapter splits its key three ways a reset and five ways a step; every hook
draws from it in the order the JAX adapter calls them. ``FunctionalTorchVectorEnv``
is :class:`~gymnasium_tpu_torch.vector.TorchVectorEnv`, as JAX's is
``JaxVectorEnv``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.functional import FuncEnv, tree_map, vectorize_func_env
from gymnasium_tpu_torch.utils.device import resolve_device
from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv

__all__ = [
    "FunctionalTorchEnv",
    "FunctionalTorchVectorEnv",
    "make_blackjack_torch_env",
    "make_cartpole_torch_env",
    "make_cartpole_torch_vector_env",
    "make_cliffwalking_torch_env",
    "make_pendulum_torch_env",
    "make_pendulum_torch_vector_env",
]


def _batch_of_one(tree):
    return tree_map(lambda leaf: leaf.unsqueeze(0), tree)


def _single(tree):
    return tree_map(lambda leaf: leaf[0], tree)


class FunctionalTorchEnv(gym.Env):
    """Stateful single-env shell over a :class:`FuncEnv`, carrying its state
    and a generator on ``device`` (CUDA unless the caller asks for the CPU).

    ``state`` holds the env's state without a batch axis, as the JAX
    adapter's does. Observations come back as device tensors of the single
    observation space's shape; a ``Discrete`` observation as ``np.int64``.
    """

    state: Any

    def __init__(
        self,
        func_env: FuncEnv,
        params: Any = None,
        metadata: dict[str, Any] | None = None,
        render_mode: str | None = None,
        spec: Any = None,
        device: str | torch.device | None = None,
    ):
        if metadata is None:
            metadata = {"render_modes": [], "render_fps": 50, "torch": True}
        self.device = resolve_device(device)
        self.func_env = func_env
        self.params = params if params is not None else func_env.get_default_params()
        self.metadata = metadata
        self.render_mode = render_mode
        self.spec = spec

        self.observation_space = func_env.observation_space
        self.action_space = func_env.action_space
        self._batched = vectorize_func_env(func_env, 1)

        self.state = None
        self.rng = self._generator(np.random.SeedSequence().entropy % (2**63))

        if self.render_mode == "rgb_array":
            self.render_state = self.func_env.render_init()
        else:
            self.render_state = None

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if seed is not None:
            self.rng = self._generator(seed)
        state = self._batched.initial(self.rng, self.params)
        obs = self._batched.observation(state, self.rng, self.params)
        self.state = _single(state)
        info = self.func_env.state_info(self.state, self.params)
        return self._obs_to_host(obs[0]), info

    def _action_tensor(self, action) -> torch.Tensor:
        """``action`` as a ``(1, ...)`` tensor on the device, in the dtype the
        action space's ``sample_torch`` draws (float32 or int32)."""
        action = torch.as_tensor(action, device=self.device)
        if action.is_floating_point():
            action = action.to(torch.float32)
        elif action.dtype != torch.bool:
            action = action.to(torch.int32)
        return action.unsqueeze(0)

    def step(self, action):
        assert self.state is not None, "Call reset before using step method."
        state = _batch_of_one(self.state)
        batch_action = self._action_tensor(action)
        next_state = self._batched.transition(state, batch_action, self.rng, self.params)
        observation = self._batched.observation(next_state, self.rng, self.params)
        reward = self._batched.reward(state, batch_action, next_state, self.rng, self.params)
        terminated = self._batched.terminal(next_state, self.rng, self.params)
        single_next = _single(next_state)
        info = self.func_env.transition_info(self.state, batch_action[0], single_next, self.params)
        self.state = single_next
        return self._obs_to_host(observation[0]), float(reward[0]), bool(terminated[0]), False, info

    def _obs_to_host(self, obs):
        """A ``Discrete`` observation is a python-int-like ``np.int64``, as
        the toy-text hosts return; any other stays a device tensor."""
        if isinstance(self.observation_space, gym.spaces.Discrete):
            return np.int64(obs.item())
        return obs

    def render(self):
        if self.render_mode == "rgb_array":
            self.render_state, image = self.func_env.render_image(
                self.state, self.render_state, self.params
            )
            return image
        raise NotImplementedError

    def close(self):
        if self.render_state is not None:
            self.func_env.render_close(self.render_state)
            self.render_state = None

    # -- pickling: the state to host numpy, the generator by its state -----

    def __getstate__(self):
        d = dict(self.__dict__)
        d.pop("_batched", None)
        d["render_state"] = None
        d["rng"] = self.rng.get_state().numpy()
        if self.state is not None:
            d["state"] = tree_map(lambda leaf: leaf.cpu().numpy(), self.state)
        return d

    def __setstate__(self, d):
        self.__dict__.update(d)
        self._batched = vectorize_func_env(self.func_env, 1)
        self.rng = torch.Generator(device=self.device)
        self.rng.set_state(torch.from_numpy(d["rng"]))
        if self.state is not None:
            self.state = tree_map(lambda leaf: torch.from_numpy(leaf).to(self.device), self.state)
        if self.render_mode == "rgb_array":
            self.render_state = self.func_env.render_init()


class FunctionalTorchVectorEnv(TorchVectorEnv):
    """Vectorized FuncEnv adapter: the device-resident vector env."""


# --- registration factories ----------------------------------------------

_METADATA = {"render_modes": ["rgb_array"], "render_fps": 50, "torch": True}


def _torch_env_factory(func_env_cls):
    def factory(render_mode: str | None = None, device: str | torch.device | None = None, **kwargs: Any):
        env = func_env_cls(kwargs or None)
        return FunctionalTorchEnv(env, metadata=dict(_METADATA), render_mode=render_mode, device=device)

    return factory


def _torch_vector_env_factory(func_env_cls):
    def factory(
        num_envs: int,
        max_episode_steps: int | None = None,
        device: str | torch.device | None = None,
        **kwargs: Any,
    ):
        env = func_env_cls(kwargs or None)
        return TorchVectorEnv(env, num_envs=num_envs, max_episode_steps=max_episode_steps, device=device)

    return factory


def make_cartpole_torch_env(render_mode: str | None = None, device=None, **kwargs: Any):
    """Entry point for ``phys2d/CartPole``."""
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

    return _torch_env_factory(CartPoleFunctional)(render_mode=render_mode, device=device, **kwargs)


def make_cartpole_torch_vector_env(num_envs: int, max_episode_steps: int | None = None, device=None, **kwargs: Any):
    """Vector entry point for ``phys2d/CartPole``."""
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

    return _torch_vector_env_factory(CartPoleFunctional)(
        num_envs=num_envs, max_episode_steps=max_episode_steps, device=device, **kwargs
    )


def make_pendulum_torch_env(render_mode: str | None = None, device=None, **kwargs: Any):
    """Entry point for ``phys2d/Pendulum``."""
    from gymnasium_tpu_torch.envs.phys2d.pendulum import PendulumFunctional

    return _torch_env_factory(PendulumFunctional)(render_mode=render_mode, device=device, **kwargs)


def make_pendulum_torch_vector_env(num_envs: int, max_episode_steps: int | None = None, device=None, **kwargs: Any):
    """Vector entry point for ``phys2d/Pendulum``."""
    from gymnasium_tpu_torch.envs.phys2d.pendulum import PendulumFunctional

    return _torch_vector_env_factory(PendulumFunctional)(
        num_envs=num_envs, max_episode_steps=max_episode_steps, device=device, **kwargs
    )


def make_blackjack_torch_env(render_mode: str | None = None, device=None, **kwargs: Any):
    """Entry point for ``tabular/Blackjack``."""
    from gymnasium_tpu_torch.envs.tabular.blackjack import BlackjackFunctional

    return _torch_env_factory(BlackjackFunctional)(render_mode=render_mode, device=device, **kwargs)


def make_cliffwalking_torch_env(render_mode: str | None = None, device=None, **kwargs: Any):
    """Entry point for ``tabular/CliffWalking``."""
    from gymnasium_tpu_torch.envs.tabular.cliffwalking import CliffWalkingFunctional

    return _torch_env_factory(CliffWalkingFunctional)(render_mode=render_mode, device=device, **kwargs)
