"""Stateful observation wrappers (copy of the JAX package's
``wrappers/stateful_observation.py``).

Parity surface: reference gymnasium/wrappers/stateful_observation.py:34-620.
"""

from __future__ import annotations

from collections import deque
from copy import deepcopy
from typing import Any, Final, SupportsFloat

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs
from gymnasium_tpu_torch.vector.utils import batch_space, concatenate, create_empty_array
from gymnasium_tpu_torch.wrappers.utils import RunningMeanStd, create_zero_array

__all__ = [
    "DelayObservation",
    "TimeAwareObservation",
    "FrameStackObservation",
    "NormalizeObservation",
    "MaxAndSkipObservation",
]


class DelayObservation(gym.ObservationWrapper, RecordConstructorArgs):
    """Return observations ``delay`` steps late (zeros before that)."""

    def __init__(self, env: gym.Env[ObsType, ActType], delay: int):
        if not np.issubdtype(type(delay), np.integer):
            raise TypeError(f"The delay is expected to be an integer, actual type: {type(delay)}")
        if not 0 <= delay:
            raise ValueError(f"The delay needs to be greater than zero, actual value: {delay}")

        RecordConstructorArgs.__init__(self, delay=delay)
        gym.ObservationWrapper.__init__(self, env)

        self.delay: Final[int] = int(delay)
        self.observation_queue: deque = deque()

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self.observation_queue.clear()
        return super().reset(seed=seed, options=options)

    def observation(self, observation: ObsType) -> ObsType:
        """Buffer the observation, emitting the one from ``delay`` steps ago."""
        self.observation_queue.append(observation)
        if len(self.observation_queue) > self.delay:
            return self.observation_queue.popleft()
        return create_zero_array(self.observation_space)


class TimeAwareObservation(gym.ObservationWrapper, RecordConstructorArgs):
    """Append the episode time to the observation."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        flatten: bool = True,
        normalize_time: bool = False,
        *,
        dict_time_key: str = "time",
    ):
        RecordConstructorArgs.__init__(
            self, flatten=flatten, normalize_time=normalize_time, dict_time_key=dict_time_key
        )
        gym.ObservationWrapper.__init__(self, env)

        self.flatten: Final[bool] = flatten
        self.normalize_time: Final[bool] = normalize_time

        if env.spec is not None and env.spec.max_episode_steps is not None:
            self.max_timesteps = env.spec.max_episode_steps
        else:
            wrapped = env
            max_timesteps = None
            while isinstance(wrapped, gym.Wrapper):
                if hasattr(wrapped, "_max_episode_steps"):
                    max_timesteps = wrapped._max_episode_steps
                    break
                wrapped = wrapped.env
            if max_timesteps is None:
                raise ValueError(
                    "The environment must be wrapped by a TimeLimit wrapper or the spec specify a `max_episode_steps`."
                )
            self.max_timesteps = max_timesteps

        self.timesteps: int = 0

        if self.normalize_time:
            self._time_preprocess_func = lambda time: np.array(
                [time / self.max_timesteps], dtype=np.float32
            )
            time_space = spaces.Box(0.0, 1.0)
        else:
            # elapsed step count, 0 at reset (reference
            # stateful_observation.py:222-223)
            self._time_preprocess_func = lambda time: np.array([time], dtype=np.int32)
            time_space = spaces.Box(0, self.max_timesteps, dtype=np.int32)

        # compose the structured space first, then flatten if requested
        # (reference stateful_observation.py:225-249)
        if isinstance(env.observation_space, spaces.Dict):
            assert dict_time_key not in env.observation_space.keys()
            observation_space = spaces.Dict(
                {dict_time_key: time_space, **env.observation_space.spaces}
            )
            self._append_data_func = lambda obs, time: {dict_time_key: time, **obs}
        elif isinstance(env.observation_space, spaces.Tuple):
            observation_space = spaces.Tuple(
                env.observation_space.spaces + (time_space,)
            )
            self._append_data_func = lambda obs, time: obs + (time,)
        else:
            observation_space = spaces.Dict(obs=env.observation_space, time=time_space)
            self._append_data_func = lambda obs, time: {"obs": obs, "time": time}

        if self.flatten:
            self.observation_space = spaces.flatten_space(observation_space)
            self._obs_postprocess_func = lambda obs: spaces.flatten(
                observation_space, obs
            )
        else:
            self.observation_space = observation_space
            self._obs_postprocess_func = lambda obs: obs

    def observation(self, observation: ObsType):
        """Attach the (elapsed or normalized) time to the observation."""
        return self._obs_postprocess_func(
            self._append_data_func(
                observation, self._time_preprocess_func(self.timesteps)
            )
        )

    def step(self, action: ActType):
        self.timesteps += 1
        return super().step(action)

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self.timesteps = 0
        return super().reset(seed=seed, options=options)


class FrameStackObservation(gym.Wrapper, RecordConstructorArgs):
    """Stack the last ``stack_size`` observations along a new leading axis."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        stack_size: int,
        *,
        padding_type: str | ObsType = "reset",
    ):
        RecordConstructorArgs.__init__(self, stack_size=stack_size, padding_type=padding_type)
        gym.Wrapper.__init__(self, env)

        if not np.issubdtype(type(stack_size), np.integer):
            raise TypeError(
                f"The stack_size is expected to be an integer, actual type: {type(stack_size)}"
            )
        if not 0 < stack_size:
            raise ValueError(
                f"The stack_size needs to be greater than zero, actual value: {stack_size}"
            )
        if isinstance(padding_type, str) and (padding_type == "reset" or padding_type == "zero"):
            self.padding_value: ObsType = create_zero_array(env.observation_space)
        elif padding_type in env.observation_space:
            self.padding_value = padding_type
            padding_type = "_custom"
        else:
            if isinstance(padding_type, str):
                raise ValueError(f"Unexpected `padding_type`, expected 'reset', 'zero' or a custom observation space, actual value: {padding_type!r}")
            raise ValueError(f"Unexpected `padding_type`, expected 'reset', 'zero' or a custom observation space, actual value: {padding_type!r} not an instance of env observation ({env.observation_space})")

        self.observation_space = batch_space(env.observation_space, n=stack_size)
        self.stack_size: Final[int] = int(stack_size)
        self.padding_type: Final[str] = padding_type

        self.obs_queue = deque(
            [self.padding_value for _ in range(self.stack_size)], maxlen=self.stack_size
        )
        self.stacked_obs = create_empty_array(env.observation_space, n=self.stack_size)

    def step(self, action: ActType):
        obs, reward, terminated, truncated, info = self.env.step(action)
        self.obs_queue.append(obs)
        updated_obs = deepcopy(
            concatenate(self.env.observation_space, self.obs_queue, self.stacked_obs)
        )
        return updated_obs, reward, terminated, truncated, info

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        obs, info = self.env.reset(seed=seed, options=options)
        if self.padding_type == "reset":
            self.padding_value = obs
        for _ in range(self.stack_size - 1):
            self.obs_queue.append(self.padding_value)
        self.obs_queue.append(obs)
        updated_obs = deepcopy(
            concatenate(self.env.observation_space, self.obs_queue, self.stacked_obs)
        )
        return updated_obs, info


class NormalizeObservation(gym.ObservationWrapper, RecordConstructorArgs):
    """Running mean/std normalization of observations."""

    def __init__(self, env: gym.Env[ObsType, ActType], epsilon: float = 1e-8):
        RecordConstructorArgs.__init__(self, epsilon=epsilon)
        gym.ObservationWrapper.__init__(self, env)

        assert env.observation_space.shape is not None
        self.observation_space = spaces.Box(
            low=-np.inf, high=np.inf, shape=env.observation_space.shape, dtype=np.float64
        )

        self.obs_rms = RunningMeanStd(shape=self.observation_space.shape, dtype=self.observation_space.dtype)
        self.epsilon = epsilon
        self._update_running_mean = True

    @property
    def update_running_mean(self) -> bool:
        """Freeze/continue updating the running statistics."""
        return self._update_running_mean

    @update_running_mean.setter
    def update_running_mean(self, setting: bool):
        self._update_running_mean = setting

    def observation(self, observation: ObsType) -> ObsType:
        """Normalize with the current running statistics."""
        if self._update_running_mean:
            self.obs_rms.update(np.array([observation]))
        return np.asarray(
            (observation - self.obs_rms.mean) / np.sqrt(self.obs_rms.var + self.epsilon),
            dtype=np.float64,
        )


class MaxAndSkipObservation(gym.Wrapper, RecordConstructorArgs):
    """Skip ``skip`` frames, returning the pixel-max of the last two."""

    def __init__(self, env: gym.Env[ObsType, ActType], skip: int = 4):
        RecordConstructorArgs.__init__(self, skip=skip)
        gym.Wrapper.__init__(self, env)

        if not np.issubdtype(type(skip), np.integer):
            raise TypeError(f"The skip is expected to be an integer, actual type: {type(skip)}")
        if skip < 2:
            raise ValueError(f"The skip value needs to be equal or greater than two, actual value: {skip}")
        assert env.observation_space.shape is not None

        self._skip = skip
        self._obs_buffer = np.zeros(
            (2, *env.observation_space.shape), dtype=env.observation_space.dtype
        )

    def step(self, action: ActType):
        """Step the env ``skip`` times, max-pooling the final two frames."""
        total_reward = 0.0
        terminated = truncated = False
        info = {}
        obs = None
        for i in range(self._skip):
            obs, reward, terminated, truncated, info = self.env.step(action)
            if i == self._skip - 2:
                self._obs_buffer[0] = obs
            if i == self._skip - 1:
                self._obs_buffer[1] = obs
            total_reward += float(reward)
            if terminated or truncated:
                break
        max_frame = self._obs_buffer.max(axis=0)
        return max_frame, total_reward, terminated, truncated, info
