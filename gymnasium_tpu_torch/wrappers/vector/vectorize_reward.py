"""Vectorized reward wrappers: lift single-env transforms to batches (copy of
the JAX package's ``wrappers/vector/vectorize_reward.py``).

Parity surface: reference gymnasium/wrappers/vector/vectorize_reward.py.
``VectorizeTransformReward`` applies its single-env transform to each
reward on the host and returns numpy; ``TransformReward`` applies its
function to the batch as the env returned it.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorRewardWrapper
from gymnasium_tpu_torch.wrappers import transform_reward as single

__all__ = ["TransformReward", "VectorizeTransformReward", "ClipReward"]


class TransformReward(VectorRewardWrapper):
    """Apply a function to the whole batched reward array."""

    def __init__(self, env: VectorEnv, func: Callable):
        super().__init__(env)
        self.func = func

    def rewards(self, reward):
        """Apply the batched transform."""
        return self.func(reward)


class VectorizeTransformReward(VectorRewardWrapper):
    """Lift a single-env reward wrapper to a vector env
    (reference vectorize_reward.py:53)."""

    class _SingleEnv(gym.Env):
        pass

    def __init__(self, env: VectorEnv, wrapper, **kwargs: Any):
        super().__init__(env)
        self.wrapper = wrapper(self._SingleEnv(), **kwargs)

    def rewards(self, reward):
        """The elementwise transform of the single-env wrapper, vectorized."""
        return np.asarray([self.wrapper.func(r) for r in to_host(reward)])


class ClipReward(VectorizeTransformReward):
    """Batched ClipReward."""

    def __init__(
        self,
        env: VectorEnv,
        min_reward: float | np.ndarray | None = None,
        max_reward: float | np.ndarray | None = None,
    ):
        super().__init__(env, single.ClipReward, min_reward=min_reward, max_reward=max_reward)
