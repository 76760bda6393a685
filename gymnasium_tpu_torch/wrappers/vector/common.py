"""Vector-level RecordEpisodeStatistics (copy of the JAX package's
``wrappers/vector/common.py``).

Parity surface: reference gymnasium/wrappers/vector/common.py:22. The
rewards and flags are read on the host; the step's own outputs pass through
as the env returned them.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any

import numpy as np

from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorWrapper

__all__ = ["RecordEpisodeStatistics"]


class RecordEpisodeStatistics(VectorWrapper):
    """Track per-sub-env episode return/length/time into ``info["episode"]``."""

    def __init__(
        self,
        env: VectorEnv,
        buffer_length: int = 100,
        stats_key: str = "episode",
    ):
        super().__init__(env)
        self._stats_key = stats_key

        self.episode_count = 0

        self.episode_start_times: np.ndarray = np.zeros(())
        self.episode_returns: np.ndarray = np.zeros(())
        self.episode_lengths: np.ndarray = np.zeros((), dtype=int)
        self.prev_dones: np.ndarray = np.zeros((), dtype=bool)

        self.time_queue = deque(maxlen=buffer_length)
        self.return_queue = deque(maxlen=buffer_length)
        self.length_queue = deque(maxlen=buffer_length)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        obs, info = super().reset(seed=seed, options=options)

        self.episode_start_times = np.full(self.num_envs, time.perf_counter())
        self.episode_returns = np.zeros(self.num_envs)
        self.episode_lengths = np.zeros(self.num_envs, dtype=int)
        self.prev_dones = np.zeros(self.num_envs, dtype=bool)
        return obs, info

    def step(self, actions):
        (
            observations,
            rewards,
            terminations,
            truncations,
            infos,
        ) = self.env.step(actions)

        assert isinstance(infos, dict), (
            f"`vector.RecordEpisodeStatistics` requires `info` type to be `dict`, its actual type is {type(infos)}."
        )

        term = to_host(terminations)
        trunc = to_host(truncations)
        self.episode_returns[self.prev_dones] = 0
        self.episode_lengths[self.prev_dones] = 0
        self.episode_start_times[self.prev_dones] = time.perf_counter()
        self.episode_returns[~self.prev_dones] += to_host(rewards)[~self.prev_dones]
        self.episode_lengths[~self.prev_dones] += 1

        self.prev_dones = dones = np.logical_or(term, trunc)
        num_dones = np.sum(dones)

        if num_dones:
            if self._stats_key in infos or f"_{self._stats_key}" in infos:
                raise ValueError(f"Attempted to add episode stats when they already exist, info keys: {list(infos.keys())}")
            episode_time_length = np.round(
                time.perf_counter() - self.episode_start_times, 6
            )
            infos[self._stats_key] = {
                "r": np.where(dones, self.episode_returns, 0.0),
                "l": np.where(dones, self.episode_lengths, 0),
                "t": np.where(dones, episode_time_length, 0.0),
            }
            infos[f"_{self._stats_key}"] = dones

            self.episode_count += int(num_dones)

            for i in np.where(dones)[0]:
                self.time_queue.append(episode_time_length[i])
                self.return_queue.append(self.episode_returns[i])
                self.length_queue.append(self.episode_lengths[i])

        return observations, rewards, terminations, truncations, infos
