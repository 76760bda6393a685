"""Vectorized action wrappers: lift single-env transforms to batches (copy of
the JAX package's ``wrappers/vector/vectorize_action.py``).

Parity surface: reference gymnasium/wrappers/vector/vectorize_action.py.
``VectorizeTransformAction`` runs its single-env transform on each env's
action on the host (device actions are read back first) and hands the env
a numpy batch; ``TransformAction`` applies its function to the batch as the
caller gave it.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import Space
from gymnasium_tpu_torch.utils.device import batch_to_host
from gymnasium_tpu_torch.vector.utils import batch_space, concatenate, create_empty_array, iterate
from gymnasium_tpu_torch.vector.vector_env import VectorActionWrapper, VectorEnv
from gymnasium_tpu_torch.wrappers import transform_action as single

__all__ = ["TransformAction", "VectorizeTransformAction", "ClipAction", "RescaleAction"]


class TransformAction(VectorActionWrapper):
    """Apply a function to the whole batched action."""

    def __init__(
        self,
        env: VectorEnv,
        func: Callable,
        action_space: Space | None = None,
        single_action_space: Space | None = None,
    ):
        super().__init__(env)
        # space resolution matches reference vectorize_action.py:77-90
        if action_space is None:
            if single_action_space is not None:
                self.single_action_space = single_action_space
                self.action_space = batch_space(single_action_space, self.num_envs)
        else:
            self.action_space = action_space
            if single_action_space is not None:
                self.single_action_space = single_action_space
        if self.action_space != batch_space(self.single_action_space, self.num_envs):
            gym.logger.warn(
                f"For {env}, the action space and the batched single action space don't match as expected, action_space={env.action_space}, batched single_action_space={batch_space(self.single_action_space, self.num_envs)}"
            )
        self.func = func

    def actions(self, actions):
        """Apply the batched transform."""
        return self.func(actions)


class VectorizeTransformAction(VectorActionWrapper):
    """Lift a single-env action wrapper to a vector env
    (reference vectorize_action.py:99)."""

    class _SingleEnv(gym.Env):
        """Fake env exposing just the action space for the wrapper."""

        def __init__(self, action_space: Space):
            self.action_space = action_space

    def __init__(self, env: VectorEnv, wrapper, **kwargs: Any):
        super().__init__(env)

        self.wrapper = wrapper(self._SingleEnv(self.env.single_action_space), **kwargs)
        self.single_action_space = self.wrapper.action_space
        self.action_space = batch_space(self.single_action_space, self.num_envs)

        self.same_out = self.action_space == self.env.action_space
        self.out = create_empty_array(self.env.single_action_space, self.num_envs)

    def actions(self, actions):
        """Unbatch, transform each, rebatch."""
        if self.same_out:
            return concatenate(
                self.env.single_action_space,
                tuple(
                    self.wrapper.func(action)
                    for action in iterate(self.action_space, batch_to_host(actions))
                ),
                actions,
            )
        import copy

        return copy.deepcopy(
            concatenate(
                self.env.single_action_space,
                tuple(
                    self.wrapper.func(action)
                    for action in iterate(self.action_space, batch_to_host(actions))
                ),
                self.out,
            )
        )


class ClipAction(VectorizeTransformAction):
    """Batched ClipAction."""

    def __init__(self, env: VectorEnv):
        super().__init__(env, single.ClipAction)


class RescaleAction(VectorizeTransformAction):
    """Batched RescaleAction."""

    def __init__(
        self,
        env: VectorEnv,
        min_action: float | int | np.ndarray,
        max_action: float | int | np.ndarray,
    ):
        super().__init__(env, single.RescaleAction, min_action=min_action, max_action=max_action)
