"""Wrapper helpers: running mean/std and zero-array construction (copy of
the JAX package's ``wrappers/utils.py``).

Parity surface: reference gymnasium/wrappers/utils.py:30-130 (behavior, not
structure — the zero-element builder here is a type registry rather than a
``singledispatch`` chain, and the moment merge is weight-based).
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch import Space
from gymnasium_tpu_torch.error import CustomSpaceError
from gymnasium_tpu_torch.spaces import (
    Box,
    Dict,
    Discrete,
    Graph,
    MultiBinary,
    MultiDiscrete,
    OneOf,
    Sequence,
    Text,
    Tuple,
)

__all__ = ["RunningMeanStd", "update_mean_var_count_from_moments", "create_zero_array"]


def merge_moments(stats_a, stats_b):
    """Chan et al. parallel merge of two ``(mean, var, weight)`` moment sets.

    Returns the moments of the union: the combined mean is the
    weight-convex combination, and the combined second central moment adds
    the between-set term ``d^2 * w_a*w_b/w``.
    """
    mean_a, var_a, w_a = stats_a
    mean_b, var_b, w_b = stats_b
    w = w_a + w_b
    d = mean_b - mean_a
    mean = mean_a + d * (w_b / w)
    m2 = var_a * w_a + var_b * w_b + np.square(d) * (w_a * w_b / w)
    return mean, m2 / w, w


def update_mean_var_count_from_moments(mean, var, count, batch_mean, batch_var, batch_count):
    """Fold batch moments into running statistics (reference-compatible
    signature over :func:`merge_moments`)."""
    return merge_moments((mean, var, count), (batch_mean, batch_var, batch_count))


class RunningMeanStd:
    """Tracks running mean/variance with Chan's parallel update."""

    def __init__(self, epsilon: float = 1e-4, shape: tuple[int, ...] = (), dtype=np.float64):
        self.mean = np.zeros(shape, dtype=dtype)
        self.var = np.ones(shape, dtype=dtype)
        self.count = epsilon

    def update(self, x: np.ndarray):
        """Fold a batch of samples (leading axis) into the statistics."""
        self.update_from_moments(np.mean(x, axis=0), np.var(x, axis=0), x.shape[0])

    def update_from_moments(self, batch_mean, batch_var, batch_count):
        """Fold precomputed batch moments into the statistics."""
        self.mean, self.var, self.count = merge_moments(
            (self.mean, self.var, self.count), (batch_mean, batch_var, batch_count)
        )


# -- zero elements -----------------------------------------------------------
#
# ``create_zero_array(space)`` produces the padding element used by
# Delay/FrameStack-style wrappers: all-zero where zero is inside the space,
# clamped to the nearest bound otherwise. Organized as an explicit
# type->builder table (new space types append to ``_ZERO_BUILDERS``).


def _zero_box(space: Box):
    out = np.zeros(space.shape, dtype=space.dtype)
    out = np.where(space.low > 0, space.low, out)
    return np.where(space.high < 0, space.high, out)


def _zero_sequence(space: Sequence):
    if not space.stack:
        return tuple()
    from gymnasium_tpu_torch.vector.utils import create_empty_array

    return create_empty_array(space.feature_space, 0)


def _zero_graph(space: Graph):
    from gymnasium_tpu_torch.spaces import GraphInstance

    nodes = create_zero_array(space.node_space)[None]
    if space.edge_space is None:
        return GraphInstance(nodes=nodes, edges=None, edge_links=None)
    return GraphInstance(
        nodes=nodes,
        edges=create_zero_array(space.edge_space)[None],
        edge_links=np.zeros((1, 2), dtype=np.int64),
    )


_ZERO_BUILDERS = {
    Box: _zero_box,
    Discrete: lambda space: space.start,
    MultiDiscrete: lambda space: np.array(space.start, copy=True, dtype=space.dtype),
    MultiBinary: lambda space: np.zeros(space.shape, dtype=space.dtype),
    Tuple: lambda space: tuple(create_zero_array(sub) for sub in space.spaces),
    Dict: lambda space: {k: create_zero_array(sub) for k, sub in space.spaces.items()},
    Sequence: _zero_sequence,
    Text: lambda space: space.characters[0] * space.min_length,
    Graph: _zero_graph,
    OneOf: lambda space: (np.int64(0), create_zero_array(space.spaces[0])),
}


def create_zero_array(space: Space):
    """A zero-valued element of ``space`` (used for padding)."""
    for cls in type(space).__mro__:
        builder = _ZERO_BUILDERS.get(cls)
        if builder is not None:
            return builder(space)
    if isinstance(space, Space):
        raise CustomSpaceError(
            f"No zero-element builder is known for space type `{type(space)}`; "
            "add one to gymnasium_tpu_torch.wrappers.utils._ZERO_BUILDERS to support it."
        )
    raise TypeError(
        f"create_zero_array expects a gymnasium space, got type {type(space)}: {space}"
    )


def rescale_box(box, new_min, new_max):
    """Affine rescale of a Box with inf-aware bounds: unbounded components
    must stay unbounded and pass through unscaled (reference
    wrappers/utils.py:156-236).

    Returns ``(new_box, forward, backward)`` where forward maps original ->
    rescaled and backward maps rescaled -> original.
    """
    assert isinstance(box, Box)

    def as_bound(value, name):
        if isinstance(value, np.ndarray):
            bound = value
        else:
            assert np.issubdtype(type(value), np.integer) or np.issubdtype(
                type(value), np.floating
            ), f"{name} must be numeric or an ndarray, got {type(value)}"
            bound = np.full(box.shape, value)
        assert bound.shape == box.shape, (
            f"{name} shape {bound.shape} does not match the box shape {box.shape}"
        )
        return bound

    new_min = as_bound(new_min, "new_min")
    new_max = as_bound(new_max, "new_max")
    # infinite bounds must be preserved verbatim: they pass through unscaled
    assert np.all((new_min == box.low)[np.isinf(new_min) | np.isinf(box.low)])
    assert np.all((new_max == box.high)[np.isinf(new_max) | np.isinf(box.high)])
    assert np.all(new_min <= new_max)
    assert np.all(box.low <= box.high)

    # the old-range width can overflow the box dtype; use the widest float
    wide = getattr(np, "float128", np.float64)

    min_finite = np.isfinite(new_min)
    max_finite = np.isfinite(new_max)
    both_finite = min_finite & max_finite

    old_width = np.asarray(box.high[both_finite], dtype=wide) - np.asarray(
        box.low[both_finite], dtype=wide
    )

    gradient = np.ones_like(new_min, dtype=box.dtype)
    gradient[both_finite] = (new_max[both_finite] - new_min[both_finite]) / old_width

    intercept = np.zeros_like(new_min, dtype=box.dtype)
    # where both bounds are finite, lower-bound anchoring takes precedence
    intercept[max_finite] = new_max[max_finite] - box.high[max_finite]
    intercept[min_finite] = gradient[min_finite] * -box.low[min_finite] + new_min[min_finite]

    new_box = Box(low=new_min, high=new_max, shape=box.shape, dtype=box.dtype)

    def forward(obs):
        return gradient * obs + intercept

    def backward(obs):
        return (obs - intercept) / gradient

    return new_box, forward, backward
