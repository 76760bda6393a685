"""Vector-level NormalizeReward (copy of the JAX package's
``wrappers/vector/stateful_reward.py``).

Parity surface: reference gymnasium/wrappers/vector/stateful_reward.py:20.
The rewards and terminations are read on the host, so the rewards come back
as numpy, as JAX's do over its device env.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorWrapper
from gymnasium_tpu_torch.wrappers.utils import RunningMeanStd

__all__ = ["NormalizeReward"]


class NormalizeReward(VectorWrapper):
    """Normalize batched rewards by the std of the discounted return."""

    def __init__(
        self,
        env: VectorEnv,
        gamma: float = 0.99,
        epsilon: float = 1e-8,
    ):
        super().__init__(env)

        self.return_rms = RunningMeanStd(shape=())
        self.accumulated_reward: np.ndarray = np.zeros((self.num_envs,), dtype=np.float32)
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

    def step(self, actions):
        obs, reward, terminated, truncated, infos = super().step(actions)
        reward = to_host(reward)
        self.accumulated_reward = (
            self.accumulated_reward * self.gamma * (1 - np.asarray(to_host(terminated), dtype=np.float32))
            + reward
        )
        if self._update_running_mean:
            self.return_rms.update(self.accumulated_reward)
        normalized = reward / np.sqrt(self.return_rms.var + self.epsilon)
        return obs, normalized, terminated, truncated, infos
