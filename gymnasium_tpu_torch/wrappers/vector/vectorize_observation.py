"""Vectorized observation wrappers: lift single-env transforms to batches
(copy of the JAX package's ``wrappers/vector/vectorize_observation.py``).

Parity surface: reference gymnasium/wrappers/vector/vectorize_observation.py
(TransformObservation, VectorizeTransformObservation and the batched
mirrors of the single-env observation wrappers).

``VectorizeTransformObservation`` runs its single-env transform on each
env's observation on the host (a device batch is read back first) and
returns numpy. Where the space is unchanged it writes the results back into
the env's own batch, as JAX does; a tensor is no numpy array, so that
raises ``TypeError`` as JAX's does over its device env.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Sequence

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import Space
from gymnasium_tpu_torch.utils.device import batch_to_host
from gymnasium_tpu_torch.vector.utils import batch_space, concatenate, create_empty_array, iterate
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorObservationWrapper
from gymnasium_tpu_torch.wrappers import transform_observation as single

__all__ = [
    "TransformObservation",
    "VectorizeTransformObservation",
    "FilterObservation",
    "FlattenObservation",
    "GrayscaleObservation",
    "ResizeObservation",
    "ReshapeObservation",
    "RescaleObservation",
    "DtypeObservation",
]


class TransformObservation(VectorObservationWrapper):
    """Apply a function to the whole batched observation."""

    def __init__(
        self,
        env: VectorEnv,
        func: Callable,
        observation_space: Space | None = None,
        single_observation_space: Space | None = None,
    ):
        super().__init__(env)
        # space resolution matches reference vectorize_observation.py:72-88:
        # a given single space implies the batched space; a mismatch between
        # the two emits a warning rather than raising
        if observation_space is None:
            if single_observation_space is not None:
                self.single_observation_space = single_observation_space
                self.observation_space = batch_space(single_observation_space, self.num_envs)
        else:
            self.observation_space = observation_space
            if single_observation_space is not None:
                self.single_observation_space = single_observation_space
        if self.observation_space != batch_space(self.single_observation_space, self.num_envs):
            gym.logger.warn(
                f"For {env}, the observation space and the batched single observation space don't match as expected, observation_space={env.observation_space}, batched single_observation_space={batch_space(self.single_observation_space, self.num_envs)}"
            )
        self.func = func

    def observations(self, observations):
        """Apply the batched transform."""
        return self.func(observations)


class VectorizeTransformObservation(VectorObservationWrapper):
    """Lift a single-env observation wrapper to a vector env
    (reference vectorize_observation.py:98)."""

    class _SingleEnv(gym.Env):
        """Fake env exposing just the observation space for the wrapper."""

        def __init__(self, observation_space: Space):
            self.observation_space = observation_space

    def __init__(self, env: VectorEnv, wrapper, **kwargs: Any):
        super().__init__(env)

        self.wrapper = wrapper(self._SingleEnv(self.env.single_observation_space), **kwargs)
        self.single_observation_space = self.wrapper.observation_space
        self.observation_space = batch_space(self.single_observation_space, self.num_envs)

        self.same_out = self.observation_space == self.env.observation_space
        self.out = create_empty_array(self.single_observation_space, self.num_envs)

    def observations(self, observations):
        """Unbatch, transform each, rebatch."""
        if self.same_out:
            return concatenate(
                self.single_observation_space,
                tuple(
                    self.wrapper.func(obs)
                    for obs in iterate(self.observation_space, batch_to_host(observations))
                ),
                observations,
            )
        return deepcopy(
            concatenate(
                self.single_observation_space,
                tuple(
                    self.wrapper.func(obs)
                    for obs in iterate(self.env.observation_space, batch_to_host(observations))
                ),
                self.out,
            )
        )


class FilterObservation(VectorizeTransformObservation):
    """Batched FilterObservation."""

    def __init__(self, env: VectorEnv, filter_keys: Sequence[str | int]):
        super().__init__(env, single.FilterObservation, filter_keys=filter_keys)


class FlattenObservation(VectorizeTransformObservation):
    """Batched FlattenObservation."""

    def __init__(self, env: VectorEnv):
        super().__init__(env, single.FlattenObservation)


class GrayscaleObservation(VectorizeTransformObservation):
    """Batched GrayscaleObservation."""

    def __init__(self, env: VectorEnv, keep_dim: bool = False):
        super().__init__(env, single.GrayscaleObservation, keep_dim=keep_dim)


class ResizeObservation(VectorizeTransformObservation):
    """Batched ResizeObservation."""

    def __init__(self, env: VectorEnv, shape: tuple[int, ...]):
        super().__init__(env, single.ResizeObservation, shape=shape)


class ReshapeObservation(VectorizeTransformObservation):
    """Batched ReshapeObservation."""

    def __init__(self, env: VectorEnv, shape: int | tuple[int, ...]):
        super().__init__(env, single.ReshapeObservation, shape=shape)


class RescaleObservation(VectorizeTransformObservation):
    """Batched RescaleObservation."""

    def __init__(
        self,
        env: VectorEnv,
        min_obs: np.floating | int | float | np.ndarray,
        max_obs: np.floating | int | float | np.ndarray,
    ):
        super().__init__(env, single.RescaleObservation, min_obs=min_obs, max_obs=max_obs)


class DtypeObservation(VectorizeTransformObservation):
    """Batched DtypeObservation."""

    def __init__(self, env: VectorEnv, dtype: Any):
        super().__init__(env, single.DtypeObservation, dtype=dtype)
