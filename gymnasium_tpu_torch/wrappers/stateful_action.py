"""Stateful action wrappers (copy of the JAX package's
``wrappers/stateful_action.py``).

Parity surface: reference gymnasium/wrappers/stateful_action.py:16-120.
"""

from __future__ import annotations

from typing import Any

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.error import InvalidProbability
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = ["StickyAction"]


class StickyAction(gym.ActionWrapper, RecordConstructorArgs):
    """Repeat the previous action with some probability (for some duration)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        repeat_action_probability: float,
        repeat_action_duration: int | tuple[int, int] = 1,
    ):
        if not 0 <= repeat_action_probability < 1:
            raise InvalidProbability(
                f"`repeat_action_probability` should be in the interval [0,1). Received {repeat_action_probability}"
            )
        if isinstance(repeat_action_duration, int):
            repeat_action_duration = (repeat_action_duration, repeat_action_duration)
        if not isinstance(repeat_action_duration, tuple):
            raise ValueError(
                f"`repeat_action_duration` should be either an integer or a tuple. Received {repeat_action_duration}"
            )
        elif len(repeat_action_duration) != 2:
            raise ValueError(
                f"`repeat_action_duration` should be a tuple of two integers. Received {repeat_action_duration}"
            )
        elif repeat_action_duration[0] > repeat_action_duration[1]:
            raise ValueError(
                f"`repeat_action_duration` is expected to be ordered (min, max). Received {repeat_action_duration}"
            )
        elif repeat_action_duration[0] < 1:
            raise ValueError(
                f"`repeat_action_duration` minimum duration should be at least 1. Received {repeat_action_duration}"
            )

        RecordConstructorArgs.__init__(
            self,
            repeat_action_probability=repeat_action_probability,
            repeat_action_duration=repeat_action_duration,
        )
        gym.ActionWrapper.__init__(self, env)

        self.repeat_action_probability = repeat_action_probability
        self.repeat_duration_range = repeat_action_duration

        self.last_action: ActType | None = None
        self.repeats_left: int = 0

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        self.last_action = None
        self.repeats_left = 0
        return super().reset(seed=seed, options=options)

    def action(self, action: ActType) -> ActType:
        """Possibly replace the submitted action with the sticky one."""
        if self.repeats_left > 0:
            self.repeats_left -= 1
            assert self.last_action is not None
            return self.last_action

        if (
            self.last_action is not None
            and self.np_random.uniform() < self.repeat_action_probability
        ):
            executed = self.last_action
            low, high = self.repeat_duration_range
            # total duration counts this step; sample remaining repeats
            self.repeats_left = int(self.np_random.integers(low, high + 1)) - 1
        else:
            executed = action
        self.last_action = executed
        return executed
