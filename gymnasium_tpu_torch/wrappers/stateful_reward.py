"""Stateful reward wrappers (copy of the JAX package's
``wrappers/stateful_reward.py``).

Parity surface: reference gymnasium/wrappers/stateful_reward.py:19-140.
"""

from __future__ import annotations

from typing import Any, SupportsFloat

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs
from gymnasium_tpu_torch.wrappers.utils import RunningMeanStd

__all__ = ["NormalizeReward"]


class NormalizeReward(gym.Wrapper, RecordConstructorArgs):
    """Normalize rewards so discounted-return variance is approximately 1."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        gamma: float = 0.99,
        epsilon: float = 1e-8,
    ):
        RecordConstructorArgs.__init__(self, gamma=gamma, epsilon=epsilon)
        gym.Wrapper.__init__(self, env)

        self.return_rms = RunningMeanStd(shape=())
        self.discounted_reward: np.ndarray = np.array([0.0])
        self.gamma = gamma
        self.epsilon = epsilon
        self._update_running_mean = True

    @property
    def update_running_mean(self) -> bool:
        """Freeze/continue updating the running return statistics."""
        return self._update_running_mean

    @update_running_mean.setter
    def update_running_mean(self, setting: bool):
        self._update_running_mean = setting

    def step(self, action: ActType):
        obs, reward, terminated, truncated, info = super().step(action)
        self.discounted_reward = self.discounted_reward * self.gamma * (
            1 - terminated
        ) + float(reward)
        if self._update_running_mean:
            self.return_rms.update(self.discounted_reward)
        normalized_reward = reward / np.sqrt(self.return_rms.var + self.epsilon)
        return obs, normalized_reward, terminated, truncated, info
