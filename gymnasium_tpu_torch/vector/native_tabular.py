"""NativeTabularVectorEnv: C++-stepped batched toy-text environments (own
copy of the JAX package's ``vector/native_tabular.py``).

The host-side analogue of the device tabular functional envs: one call into
the compiled stepper (``native/tabular.cpp``) advances all N envs, replacing
SyncVectorEnv's Python per-env loop for tabular workloads. The draws come
from the env's PCG64 generator, so a seed gives the same states as the JAX
package's class, bit for bit. The env runs on the host and takes no device.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.native import TabularBatchStepper
from gymnasium_tpu_torch.vector.utils import batch_space
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv

__all__ = ["NativeTabularVectorEnv"]


class NativeTabularVectorEnv(VectorEnv):
    """Batched tabular envs stepped natively with next-step autoreset."""

    metadata = {"autoreset_mode": AutoresetMode.NEXT_STEP, "render_modes": []}

    def __init__(
        self,
        model,
        num_envs: int = 1,
        max_episode_steps: int | None = None,
    ):
        self.model = model
        self.num_envs = num_envs
        self.max_episode_steps = max_episode_steps
        self.stepper = TabularBatchStepper(model)

        self.single_observation_space = spaces.Discrete(model.num_states)
        self.single_action_space = spaces.Discrete(model.num_actions)
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

        self.states = np.zeros(num_envs, dtype=np.int32)
        self.steps = np.zeros(num_envs, dtype=np.int32)
        self.prev_done = np.zeros(num_envs, dtype=bool)

    def _sample_initial(self, n: int) -> np.ndarray:
        cum = np.cumsum(self.model.initial_probs)
        u = self.np_random.random(n)
        return np.argmax(cum[None, :] > u[:, None], axis=1).astype(np.int32)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        self.states = self._sample_initial(self.num_envs)
        self.steps = np.zeros(self.num_envs, dtype=np.int32)
        self.prev_done = np.zeros(self.num_envs, dtype=bool)
        return self.states.copy().astype(np.int64), {}

    def step(self, actions):
        actions = np.asarray(actions, dtype=np.int32)
        to_reset = self.prev_done
        uniforms = self.np_random.random(self.num_envs)
        rewards, terms = self.stepper.step(self.states, actions, uniforms)
        terminated = terms.astype(bool)

        self.steps += 1
        if self.max_episode_steps is not None:
            truncated = self.steps >= self.max_episode_steps
        else:
            truncated = np.zeros(self.num_envs, dtype=bool)

        if to_reset.any():
            n_reset = int(to_reset.sum())
            self.states[to_reset] = self._sample_initial(n_reset)
            self.steps[to_reset] = 0
            rewards[to_reset] = 0.0
            terminated[to_reset] = False
            truncated[to_reset] = False

        self.prev_done = terminated | truncated
        return (
            self.states.copy().astype(np.int64),
            rewards,
            terminated,
            truncated,
            {},
        )


# -- registration factories -------------------------------------------------


def _make_factory(build_model):
    def factory(num_envs: int = 1, max_episode_steps: int | None = None, **kwargs: Any):
        return NativeTabularVectorEnv(
            build_model(**kwargs), num_envs=num_envs, max_episode_steps=max_episode_steps
        )

    return factory


def make_frozen_lake_vector(num_envs: int = 1, max_episode_steps: int | None = None, **kwargs: Any):
    """Native vector entry point for FrozenLake."""
    from gymnasium_tpu_torch.envs.toy_text.frozen_lake import MAPS, build_frozen_lake_model

    desc = kwargs.pop("desc", None)
    map_name = kwargs.pop("map_name", "4x4")
    if desc is None:
        desc = MAPS[map_name]
    desc = np.asarray(desc, dtype="c")
    model = build_frozen_lake_model(desc, kwargs.pop("is_slippery", True))
    return NativeTabularVectorEnv(model, num_envs=num_envs, max_episode_steps=max_episode_steps)


def make_cliffwalking_vector(num_envs: int = 1, max_episode_steps: int | None = None, **kwargs: Any):
    """Native vector entry point for CliffWalking."""
    from gymnasium_tpu_torch.envs.toy_text.cliffwalking import build_cliffwalking_model

    model = build_cliffwalking_model(kwargs.pop("is_slippery", False))
    return NativeTabularVectorEnv(model, num_envs=num_envs, max_episode_steps=max_episode_steps)


def make_taxi_vector(num_envs: int = 1, max_episode_steps: int | None = None, **kwargs: Any):
    """Native vector entry point for Taxi."""
    from gymnasium_tpu_torch.envs.toy_text.taxi import build_taxi_model

    kwargs.pop("fickle_passenger", None)
    model = build_taxi_model(kwargs.pop("is_rainy", False))
    return NativeTabularVectorEnv(model, num_envs=num_envs, max_episode_steps=max_episode_steps)
