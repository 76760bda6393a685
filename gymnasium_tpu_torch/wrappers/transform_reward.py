"""Stateless reward-transform wrappers (copy of the JAX package's
``wrappers/transform_reward.py``).

Parity surface: reference gymnasium/wrappers/transform_reward.py:21-110.
"""

from __future__ import annotations

from typing import Callable, SupportsFloat

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = ["TransformReward", "ClipReward"]


class TransformReward(gym.RewardWrapper, RecordConstructorArgs):
    """Apply ``func`` to every reward."""

    def __init__(self, env: gym.Env[ObsType, ActType], func: Callable[[SupportsFloat], SupportsFloat]):
        RecordConstructorArgs.__init__(self, func=func)
        gym.RewardWrapper.__init__(self, env)
        self.func = func

    def reward(self, reward: SupportsFloat) -> SupportsFloat:
        """Apply the transform."""
        return self.func(reward)


class ClipReward(TransformReward, RecordConstructorArgs):
    """Clip rewards into ``[min_reward, max_reward]``."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        min_reward: float | np.ndarray | None = None,
        max_reward: float | np.ndarray | None = None,
    ):
        if min_reward is None and max_reward is None:
            raise gym.error.InvalidBound("Both `min_reward` and `max_reward` cannot be None")
        elif max_reward is not None and min_reward is not None and np.less(max_reward, min_reward).any():
            raise gym.error.InvalidBound(
                f"Min reward ({min_reward}) must be smaller than max reward ({max_reward})"
            )
        RecordConstructorArgs.__init__(self, min_reward=min_reward, max_reward=max_reward)
        TransformReward.__init__(
            self, env=env, func=lambda x: np.clip(x, a_min=min_reward, a_max=max_reward)
        )
