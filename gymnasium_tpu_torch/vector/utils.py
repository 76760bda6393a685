"""Space batching for vector environments (``Box`` and ``Discrete`` only).

Copy of the JAX package's ``vector/utils/space_utils.batch_space`` for the two
spaces this slice uses: a Box stacks along a new leading axis, a Discrete
becomes a MultiDiscrete.
"""

from __future__ import annotations

from copy import deepcopy
from functools import singledispatch
from typing import Any

import numpy as np

from gymnasium_tpu_torch.spaces import Box, Discrete, MultiDiscrete, Space

__all__ = ["batch_space"]


@singledispatch
def batch_space(space: Space[Any], n: int = 1) -> Space[Any]:
    """Space for a batch of ``n`` samples from ``space`` (leading axis)."""
    raise TypeError(f"batch_space supports Box and Discrete, got {type(space)}: {space}")


@batch_space.register(Box)
def _batch_space_box(space: Box, n: int = 1) -> Box:
    repeats = tuple([n] + [1] * space.low.ndim)
    low, high = np.tile(space.low, repeats), np.tile(space.high, repeats)
    return Box(low=low, high=high, dtype=space.dtype, seed=deepcopy(space.np_random))


@batch_space.register(Discrete)
def _batch_space_discrete(space: Discrete, n: int = 1) -> MultiDiscrete:
    return MultiDiscrete(
        np.full((n,), space.n, dtype=space.dtype),
        dtype=space.dtype,
        seed=deepcopy(space.np_random),
        start=np.full((n,), space.start, dtype=space.dtype),
    )
