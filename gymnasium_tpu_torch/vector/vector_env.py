"""VectorEnv base protocol and autoreset modes.

Copy of ``AutoresetMode`` and the ``VectorEnv`` base of the JAX package's
``vector/vector_env.py``; the vector wrapper family and the info batching of
the host-side vector envs wait for a later slice.
"""

from __future__ import annotations

from enum import Enum
from typing import Any, Generic, TypeVar

import numpy as np

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils import seeding

__all__ = ["VectorEnv", "AutoresetMode", "ArrayType"]

ArrayType = TypeVar("ArrayType")
ObsType = TypeVar("ObsType")
ActType = TypeVar("ActType")


class AutoresetMode(Enum):
    """When episode-ending sub-envs are reset."""

    NEXT_STEP = "NextStep"
    SAME_STEP = "SameStep"
    DISABLED = "Disabled"


class VectorEnv(Generic[ObsType, ActType, ArrayType]):
    """Batched environment: N lockstep sub-environments behind one step call."""

    metadata: dict[str, Any] = {}
    spec: Any = None
    render_mode: str | None = None
    closed: bool = False

    observation_space: spaces.Space
    action_space: spaces.Space
    single_observation_space: spaces.Space
    single_action_space: spaces.Space

    num_envs: int

    _np_random: np.random.Generator | None = None
    _np_random_seed: int | None = None

    def reset(
        self,
        *,
        seed: int | None = None,
        options: dict[str, Any] | None = None,
    ) -> tuple[ObsType, dict[str, Any]]:
        """Reset all sub-environments, returning batched obs and info."""
        if seed is not None:
            self._np_random, self._np_random_seed = seeding.np_random(seed)
        return None, {}  # type: ignore[return-value]

    def step(
        self, actions: ActType
    ) -> tuple[ObsType, ArrayType, ArrayType, ArrayType, dict[str, Any]]:
        """Step all sub-environments with batched ``actions``."""
        raise NotImplementedError(f"{self.__str__()} step function is not implemented.")

    def render(self) -> tuple | None:
        """Render the sub-environments."""
        raise NotImplementedError(f"{self.__str__()} render function is not implemented.")

    def close(self, **kwargs: Any):
        """Close all sub-environments (idempotent)."""
        if self.closed:
            return
        self.close_extras(**kwargs)
        self.closed = True

    def close_extras(self, **kwargs: Any):
        """Clean up resources beyond what :meth:`close` does by default."""
        pass

    # -- RNG ---------------------------------------------------------------

    @property
    def np_random(self) -> np.random.Generator:
        """Lazily-initialised PCG64 generator."""
        if self._np_random is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator):
        self._np_random = value
        self._np_random_seed = -1

    @property
    def np_random_seed(self) -> int | None:
        """Seed of the env's PRNG (-1 if the generator was set directly)."""
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random_seed

    @property
    def unwrapped(self):
        """The base VectorEnv."""
        return self

    def __del__(self):
        if not getattr(self, "closed", True):
            try:
                self.close()
            except Exception:
                pass

    def __repr__(self) -> str:
        if self.spec is None:
            return f"{self.__class__.__name__}(num_envs={self.num_envs})"
        return f"{self.__class__.__name__}({self.spec.id}, num_envs={self.num_envs})"
