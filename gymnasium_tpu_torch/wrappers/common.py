"""Common wrappers applied by ``make``: TimeLimit, Autoreset,
PassiveEnvChecker, OrderEnforcing, RecordEpisodeStatistics.

Parity with reference gymnasium/wrappers/common.py:42-548.
"""

from __future__ import annotations

import time
from collections import deque
from typing import TYPE_CHECKING, Any, SupportsFloat

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import error, logger
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.passive_env_checker import (
    check_action_space,
    check_observation_space,
    env_render_passive_checker,
    env_reset_passive_checker,
    env_step_passive_checker,
)
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

if TYPE_CHECKING:
    from gymnasium_tpu_torch.envs.registration import EnvSpec

__all__ = [
    "TimeLimit",
    "Autoreset",
    "PassiveEnvChecker",
    "OrderEnforcing",
    "RecordEpisodeStatistics",
]


class TimeLimit(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Truncate episodes after ``max_episode_steps`` steps
    (reference common.py:42-131)."""

    def __init__(self, env: gym.Env, max_episode_steps: int):
        assert (
            isinstance(max_episode_steps, int) and max_episode_steps > 0
        ), f"Expect the `max_episode_steps` to be positive, actually: {max_episode_steps}"
        RecordConstructorArgs.__init__(self, max_episode_steps=max_episode_steps)
        gym.Wrapper.__init__(self, env)
        self._max_episode_steps = max_episode_steps
        self._elapsed_steps: int | None = None

    @property
    def max_episode_steps(self) -> int:
        """The max episode steps before truncation."""
        return self._max_episode_steps

    def step(self, action):
        observation, reward, terminated, truncated, info = self.env.step(action)
        self._elapsed_steps += 1
        if self._elapsed_steps >= self._max_episode_steps:
            truncated = True
        return observation, reward, terminated, truncated, info

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self._elapsed_steps = 0
        return self.env.reset(seed=seed, options=options)

    @property
    def spec(self) -> EnvSpec | None:
        """Record the limit in ``spec.max_episode_steps`` instead of a
        WrapperSpec so `make(spec)` reapplies it natively (reference
        common.py:107-124)."""
        if self._cached_spec is not None:
            return self._cached_spec
        env_spec = self.env.spec
        if env_spec is not None:
            from copy import deepcopy

            try:
                env_spec = deepcopy(env_spec)
                env_spec.max_episode_steps = self._max_episode_steps
            except Exception as e:
                logger.warn(
                    f"An exception occurred ({e}) while copying the environment spec={env_spec}"
                )
                return None
        self._cached_spec = env_spec
        return env_spec


class Autoreset(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Next-step autoreset for a single env (reference common.py:168-218)."""

    def __init__(self, env: gym.Env):
        RecordConstructorArgs.__init__(self)
        gym.Wrapper.__init__(self, env)
        self.autoreset = False

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self.autoreset = False
        return super().reset(seed=seed, options=options)

    def step(self, action):
        if self.autoreset:
            obs, info = self.env.reset()
            reward, terminated, truncated = 0.0, False, False
        else:
            obs, reward, terminated, truncated, info = self.env.step(action)
        self.autoreset = terminated or truncated
        return obs, reward, terminated, truncated, info


class PassiveEnvChecker(gym.Wrapper[ObsType, ActType, ObsType, ActType]):
    """Validate the env's API on the first reset/step/render
    (reference common.py:219)."""

    def __init__(self, env: gym.Env):
        gym.Wrapper.__init__(self, env)
        if not hasattr(env, "action_space"):
            raise AttributeError(
                "The environment must specify an action space. https://gymnasium.farama.org/introduction/create_custom_env/"
            )
        check_action_space(env.action_space)
        if not hasattr(env, "observation_space"):
            raise AttributeError(
                "The environment must specify an observation space. https://gymnasium.farama.org/introduction/create_custom_env/"
            )
        check_observation_space(env.observation_space)

        self.checked_reset = False
        self.checked_step = False
        self.checked_render = False
        self.close_called = False

    def step(self, action):
        if self.checked_step is False:
            self.checked_step = True
            return env_step_passive_checker(self.env, action)
        return self.env.step(action)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        if self.checked_reset is False:
            self.checked_reset = True
            return env_reset_passive_checker(self.env, seed=seed, options=options)
        return self.env.reset(seed=seed, options=options)

    def render(self):
        if self.checked_render is False:
            self.checked_render = True
            return env_render_passive_checker(self.env)
        return self.env.render()

    @property
    def spec(self) -> EnvSpec | None:
        if self._cached_spec is not None:
            return self._cached_spec
        env_spec = self.env.spec
        if env_spec is not None:
            from copy import deepcopy

            try:
                env_spec = deepcopy(env_spec)
                env_spec.disable_env_checker = False
            except Exception as e:
                logger.warn(
                    f"An exception occurred ({e}) while copying the environment spec={env_spec}"
                )
                return None
        self._cached_spec = env_spec
        return env_spec

    def close(self):
        self.close_called = True
        return self.env.close()


class OrderEnforcing(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Forbid step/render before the first reset (reference common.py:339)."""

    def __init__(self, env: gym.Env, disable_render_order_enforcing: bool = False):
        RecordConstructorArgs.__init__(
            self, disable_render_order_enforcing=disable_render_order_enforcing
        )
        gym.Wrapper.__init__(self, env)
        self._has_reset: bool = False
        self._disable_render_order_enforcing: bool = disable_render_order_enforcing

    def step(self, action):
        if not self._has_reset:
            raise error.ResetNeeded("Cannot call env.step() before calling env.reset()")
        return super().step(action)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self._has_reset = True
        return super().reset(seed=seed, options=options)

    def render(self):
        if not self._disable_render_order_enforcing and not self._has_reset:
            raise error.ResetNeeded(
                "Cannot call `env.render()` before calling `env.reset()`, if this is an intended action, "
                "set `disable_render_order_enforcing=True` on the OrderEnforcer wrapper."
            )
        return super().render()

    @property
    def has_reset(self) -> bool:
        """Whether reset has been called."""
        return self._has_reset

    @property
    def spec(self) -> EnvSpec | None:
        if self._cached_spec is not None:
            return self._cached_spec
        env_spec = self.env.spec
        if env_spec is not None:
            from copy import deepcopy

            try:
                env_spec = deepcopy(env_spec)
                env_spec.order_enforce = True
            except Exception as e:
                logger.warn(
                    f"An exception occurred ({e}) while copying the environment spec={env_spec}"
                )
                return None
        self._cached_spec = env_spec
        return env_spec


class RecordEpisodeStatistics(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Track episode return/length/time into ``info["episode"]``
    (reference common.py:436-548)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        buffer_length: int = 100,
        stats_key: str = "episode",
    ):
        RecordConstructorArgs.__init__(self, buffer_length=buffer_length, stats_key=stats_key)
        gym.Wrapper.__init__(self, env)

        self._stats_key = stats_key
        self.episode_count = 0
        self.episode_start_time: float = -1
        self.episode_returns: float = 0.0
        self.episode_lengths: int = 0

        self.time_queue: deque[float] = deque(maxlen=buffer_length)
        self.return_queue: deque[float] = deque(maxlen=buffer_length)
        self.length_queue: deque[int] = deque(maxlen=buffer_length)

    def step(self, action):
        obs, reward, terminated, truncated, info = self.env.step(action)

        self.episode_returns += float(reward)
        self.episode_lengths += 1

        if terminated or truncated:
            assert self._stats_key not in info
            episode_time_length = round(time.perf_counter() - self.episode_start_time, 6)
            info[self._stats_key] = {
                "r": self.episode_returns,
                "l": self.episode_lengths,
                "t": episode_time_length,
            }
            self.time_queue.append(episode_time_length)
            self.return_queue.append(self.episode_returns)
            self.length_queue.append(self.episode_lengths)
            self.episode_count += 1
        return obs, reward, terminated, truncated, info

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        obs, info = super().reset(seed=seed, options=options)
        self.episode_start_time = time.perf_counter()
        self.episode_returns = 0.0
        self.episode_lengths = 0
        return obs, info
