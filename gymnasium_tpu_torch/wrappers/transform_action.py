"""Stateless action-transform wrappers (copy of the JAX package's
``wrappers/transform_action.py``).

Parity surface: reference gymnasium/wrappers/transform_action.py:24-299.
"""

from __future__ import annotations

from typing import Callable

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = ["TransformAction", "ClipAction", "RescaleAction", "DiscretizeAction"]


class TransformAction(gym.ActionWrapper, RecordConstructorArgs):
    """Apply ``func`` to every action before it reaches the env."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        func: Callable,
        action_space: gym.Space | None,
    ):
        RecordConstructorArgs.__init__(self, func=func, action_space=action_space)
        gym.ActionWrapper.__init__(self, env)
        if action_space is not None:
            self.action_space = action_space
        self.func = func

    def action(self, action):
        """Apply the transform."""
        return self.func(action)


class ClipAction(TransformAction, RecordConstructorArgs):
    """Clip continuous actions into the env's Box bounds."""

    def __init__(self, env: gym.Env[ObsType, ActType]):
        assert isinstance(env.action_space, spaces.Box)
        RecordConstructorArgs.__init__(self)
        TransformAction.__init__(
            self,
            env=env,
            func=lambda action: np.clip(action, env.action_space.low, env.action_space.high),
            action_space=spaces.Box(
                -np.inf, np.inf, shape=env.action_space.shape, dtype=env.action_space.dtype
            ),
        )


class RescaleAction(TransformAction, RecordConstructorArgs):
    """Affinely rescale actions from ``[min_action, max_action]`` into the
    env's Box bounds; infinite components pass through (reference
    transform_action.py:126-180)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        min_action: float | int | np.ndarray,
        max_action: float | int | np.ndarray,
    ):
        assert isinstance(env.action_space, spaces.Box)

        RecordConstructorArgs.__init__(self, min_action=min_action, max_action=max_action)

        from gymnasium_tpu_torch.wrappers.utils import rescale_box

        act_space, _, func = rescale_box(env.action_space, min_action, max_action)
        TransformAction.__init__(
            self,
            env=env,
            func=func,
            action_space=act_space,
        )


class DiscretizeAction(gym.ActionWrapper, RecordConstructorArgs):
    """Uniformly discretize a finite Box action space into Discrete or
    MultiDiscrete actions (reference transform_action.py:183)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        bins: int | tuple[int, ...],
        multidiscrete: bool = False,
    ):
        if not isinstance(env.action_space, spaces.Box):
            raise TypeError(
                "DiscretizeAction is only compatible with Box continuous actions."
            )
        self.low = env.action_space.low
        self.high = env.action_space.high
        self.n_dims = self.low.shape[0]
        if np.any(np.isinf(self.low)) or np.any(np.isinf(self.high)):
            raise ValueError(
                "Discretization requires action space to be finite. "
                f"Found: low={self.low}, high={self.high}"
            )
        self.multidiscrete = multidiscrete
        RecordConstructorArgs.__init__(self, bins=bins)
        gym.ActionWrapper.__init__(self, env)

        if isinstance(bins, int):
            self.bins = np.array([bins] * self.n_dims)
        else:
            assert len(bins) == self.n_dims, (
                f"bins must match action dimensions: expected {self.n_dims}, got {len(bins)}"
            )
            self.bins = np.array(bins)

        # bin centers per dimension
        self.bin_centers = [
            (np.linspace(self.low[i], self.high[i], self.bins[i] + 1)[:-1]
             + np.linspace(self.low[i], self.high[i], self.bins[i] + 1)[1:])
            / 2
            for i in range(self.n_dims)
        ]
        if self.multidiscrete:
            self.action_space = spaces.MultiDiscrete(self.bins)
        else:
            self.action_space = spaces.Discrete(int(np.prod(self.bins)))

    def action(self, action):
        """Map the discrete action to the continuous bin center."""
        if self.multidiscrete:
            indices = np.asarray(action, dtype=int)
        else:
            indices = []
            rem = int(action)
            for i in reversed(range(self.n_dims)):
                indices.append(rem % int(self.bins[i]))
                rem //= int(self.bins[i])
            indices = list(reversed(indices))
        continuous = np.array(
            [self.bin_centers[i][idx] for i, idx in enumerate(indices)],
            dtype=self.env.action_space.dtype,
        )
        return continuous

    def revert_action(self, action):
        """Map a continuous action back to the discrete index of its nearest
        bin center (reference transform_action.py:308-318)."""
        indices = [
            np.argmin(np.abs(self.bin_centers[i] - action[i]))
            for i in range(self.n_dims)
        ]
        if self.multidiscrete:
            return np.array(indices, dtype=int)
        return np.ravel_multi_index(indices, self.bins)
