"""Space batching utilities for vector environments.

Copy of the JAX package's ``vector/utils/space_utils.py``, which follows
Gymnasium's (gymnasium/vector/utils/space_utils.py:47-438):
``batch_space`` (Box → stacked Box, Discrete → MultiDiscrete, ...),
``batch_differing_spaces``, ``iterate``, ``concatenate``,
``create_empty_array`` — implemented as singledispatch over the space zoo.
"""

from __future__ import annotations

from copy import deepcopy
from functools import singledispatch
from typing import Any, Iterable, Iterator

import numpy as np

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
    Space,
    Text,
    Tuple,
)

__all__ = [
    "batch_space",
    "batch_differing_spaces",
    "iterate",
    "concatenate",
    "create_empty_array",
]


# --- batch_space ----------------------------------------------------------


@singledispatch
def batch_space(space: Space[Any], n: int = 1) -> Space[Any]:
    """Space for a batch of ``n`` samples from ``space`` (leading axis)."""
    raise TypeError(
        f"The space provided to `batch_space` is not a gymnasium Space instance, type: {type(space)}, {space}"
    )


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


@batch_space.register(MultiDiscrete)
def _batch_space_multidiscrete(space: MultiDiscrete, n: int = 1) -> Box:
    # Batches to a Box (reference space_utils.py:92-103): per-element integer
    # ranges [start, start+nvec-1] stacked along the new leading axis.
    repeats = tuple([n] + [1] * space.nvec.ndim)
    low = np.tile(space.start, repeats)
    high = low + np.tile(space.nvec, repeats) - 1
    return Box(low=low, high=high, dtype=space.dtype, seed=deepcopy(space.np_random))


@batch_space.register(MultiBinary)
def _batch_space_multibinary(space: MultiBinary, n: int = 1) -> Box:
    return Box(
        low=0,
        high=1,
        shape=(n,) + space.shape,
        dtype=space.dtype,
        seed=deepcopy(space.np_random),
    )


@batch_space.register(Tuple)
def _batch_space_tuple(space: Tuple, n: int = 1) -> Tuple:
    return Tuple(
        tuple(batch_space(subspace, n) for subspace in space.spaces),
        seed=deepcopy(space.np_random),
    )


@batch_space.register(Dict)
def _batch_space_dict(space: Dict, n: int = 1) -> Dict:
    return Dict(
        {key: batch_space(subspace, n) for key, subspace in space.items()},
        seed=deepcopy(space.np_random),
    )


@batch_space.register(Graph)
@batch_space.register(Text)
@batch_space.register(Sequence)
@batch_space.register(OneOf)
@batch_space.register(Space)
def _batch_space_custom(space: Graph | Text | Sequence | OneOf, n: int = 1) -> Tuple:
    # Variable-shape and custom spaces batch as a Tuple of copies with
    # distinct seeds (reference space_utils.py:132-147).
    batched = Tuple(
        tuple(deepcopy(space) for _ in range(n)), seed=deepcopy(space.np_random)
    )
    space_rng = deepcopy(space.np_random)
    new_seeds = list(map(int, space_rng.integers(0, 1e8, n)))
    batched.seed(new_seeds)
    return batched


def batch_differing_spaces(spaces: list[Space]) -> Space:
    """Batch a list of (possibly differing) same-type spaces
    (reference space_utils.py:150)."""
    assert len(spaces) > 0, "Expects a non-empty list of spaces"
    assert all(isinstance(space, type(spaces[0])) for space in spaces), (
        "Expects all spaces to be the same shape"
    )
    first = spaces[0]
    if isinstance(first, Box):
        assert all(first.dtype == space.dtype for space in spaces), (
            f"Expected all dtypes to be equal, actually {[space.dtype for space in spaces]}"
        )
        assert all(first.low.shape == space.low.shape for space in spaces), (
            f"Expected all Box.low shape to be equal, actually {[space.low.shape for space in spaces]}"
        )
        assert all(first.high.shape == space.high.shape for space in spaces), (
            f"Expected all Box.high shape to be equal, actually {[space.high.shape for space in spaces]}"
        )
        return Box(
            low=np.stack([space.low for space in spaces]),
            high=np.stack([space.high for space in spaces]),
            dtype=first.dtype,
            seed=deepcopy(first.np_random),
        )
    if isinstance(first, Discrete):
        dtypes = [space.dtype for space in spaces]
        largest = max(dtypes, key=lambda dt: np.dtype(dt).itemsize)
        return MultiDiscrete(
            nvec=np.array([space.n for space in spaces]),
            dtype=largest,
            start=np.array([space.start for space in spaces]),
            seed=deepcopy(first.np_random),
        )
    if isinstance(first, MultiDiscrete):
        assert all(first.dtype == space.dtype for space in spaces), (
            f"Expected all dtypes to be equal, actually {[space.dtype for space in spaces]}"
        )
        assert all(first.nvec.shape == space.nvec.shape for space in spaces), (
            f"Expects all MultiDiscrete.nvec shape, actually {[space.nvec.shape for space in spaces]}"
        )
        assert all(first.start.shape == space.start.shape for space in spaces), (
            f"Expects all MultiDiscrete.start shape, actually {[space.start.shape for space in spaces]}"
        )
        return Box(
            low=np.array([space.start for space in spaces]),
            high=np.array([space.start + space.nvec for space in spaces]) - 1,
            dtype=first.dtype,
            seed=deepcopy(first.np_random),
        )
    if isinstance(first, MultiBinary):
        assert all(space.shape == first.shape for space in spaces)
        return Box(
            low=0,
            high=1,
            shape=(len(spaces),) + first.shape,
            dtype=first.dtype,
            seed=deepcopy(first.np_random),
        )
    if isinstance(first, Tuple):
        return Tuple(
            tuple(
                batch_differing_spaces([space.spaces[i] for space in spaces])
                for i in range(len(first.spaces))
            ),
            seed=deepcopy(first.np_random),
        )
    if isinstance(first, Dict):
        assert all(space.keys() == first.keys() for space in spaces)
        return Dict(
            {
                key: batch_differing_spaces([space[key] for space in spaces])
                for key in first.keys()
            },
            seed=deepcopy(first.np_random),
        )
    # Fallback: tuple of the spaces themselves.
    return Tuple(tuple(deepcopy(space) for space in spaces), seed=deepcopy(first.np_random))


# --- iterate --------------------------------------------------------------


@singledispatch
def iterate(space: Space[Any], items: Any) -> Iterator:
    """Iterate over the elements of a batched sample."""
    if isinstance(space, Space):
        raise CustomSpaceError(
            f"Space of type `{type(space)}` doesn't have an registered `iterate` function. Register `{type(space)}` for `iterate` to support it."
        )
    raise TypeError(f"The space provided to `iterate` is not a gymnasium Space instance, type: {type(space)}, {space}")


@iterate.register(Discrete)
def _iterate_discrete(space: Discrete, items: Iterable):
    raise TypeError("Unable to iterate over a space of type `Discrete`.")


@iterate.register(Box)
@iterate.register(MultiDiscrete)
@iterate.register(MultiBinary)
def _iterate_base(space: Box | MultiDiscrete | MultiBinary, items: np.ndarray):
    try:
        return iter(items)
    except TypeError as e:
        raise TypeError(f"Unable to iterate over the following elements: {items}") from e


@iterate.register(Tuple)
def _iterate_tuple(space: Tuple, items: tuple[Any, ...]):
    # If all subspaces are the same, the batched sample is a tuple of batches.
    unbatchable = [s for s in space.spaces if type(s) in (Graph, Text, Sequence, OneOf)]
    if len(unbatchable) == 0 and all(
        type(subspace) in iterate.registry for subspace in space.spaces
    ):
        return zip(*[iterate(subspace, items[i]) for i, subspace in enumerate(space.spaces)])
    # batched custom space: already a tuple of per-env samples
    return iter(items)


@iterate.register(Dict)
def _iterate_dict(space: Dict, items: dict[str, Any]):
    keys, values = zip(
        *[(key, iterate(subspace, items[key])) for key, subspace in space.spaces.items()]
    )
    for item in zip(*values):
        yield dict(zip(keys, item))


# --- concatenate ----------------------------------------------------------


@singledispatch
def concatenate(space: Space, items: Iterable, out: Any) -> Any:
    """Concatenate per-env samples into the preallocated batched ``out``."""
    if isinstance(space, Space):
        return tuple(items)
    raise TypeError(f"The space provided to `concatenate` is not a gymnasium Space instance, type: {type(space)}, {space}")


@concatenate.register(Box)
@concatenate.register(Discrete)
@concatenate.register(MultiDiscrete)
@concatenate.register(MultiBinary)
def _concatenate_base(space, items: Iterable, out: np.ndarray) -> np.ndarray:
    return np.stack(list(items), axis=0, out=out)


@concatenate.register(Tuple)
def _concatenate_tuple(space: Tuple, items: Iterable, out: tuple[Any, ...]) -> tuple[Any, ...]:
    items = list(items)
    return tuple(
        concatenate(subspace, [item[i] for item in items], out[i])
        for i, subspace in enumerate(space.spaces)
    )


@concatenate.register(Dict)
def _concatenate_dict(space: Dict, items: Iterable, out: dict[str, Any]) -> dict[str, Any]:
    items = list(items)
    return {
        key: concatenate(subspace, [item[key] for item in items], out[key])
        for key, subspace in space.spaces.items()
    }


@concatenate.register(Graph)
@concatenate.register(Text)
@concatenate.register(Sequence)
@concatenate.register(OneOf)
def _concatenate_custom(space, items: Iterable, out: None) -> tuple[Any, ...]:
    return tuple(items)


# --- create_empty_array ---------------------------------------------------


@singledispatch
def create_empty_array(space: Space, n: int = 1, fn: Any = np.zeros) -> Any:
    """Preallocate a batched output buffer for ``n`` samples of ``space``."""
    if isinstance(space, Space):
        # Unknown custom space: no buffer can be preallocated
        # (reference space_utils.py:540-542).
        return None
    raise TypeError(f"The space provided to `create_empty_array` is not a gymnasium Space instance, type: {type(space)}, {space}")


@create_empty_array.register(Box)
@create_empty_array.register(MultiDiscrete)
@create_empty_array.register(MultiBinary)
def _create_empty_array_base(space, n: int = 1, fn=np.zeros) -> np.ndarray:
    return fn((n,) + space.shape, dtype=space.dtype)


@create_empty_array.register(Discrete)
def _create_empty_array_discrete(space: Discrete, n: int = 1, fn=np.zeros) -> np.ndarray:
    return fn((n,), dtype=space.dtype)


@create_empty_array.register(Tuple)
def _create_empty_array_tuple(space: Tuple, n: int = 1, fn=np.zeros) -> tuple[Any, ...]:
    return tuple(create_empty_array(subspace, n=n, fn=fn) for subspace in space.spaces)


@create_empty_array.register(Dict)
def _create_empty_array_dict(space: Dict, n: int = 1, fn=np.zeros) -> dict[str, Any]:
    return {key: create_empty_array(subspace, n=n, fn=fn) for key, subspace in space.spaces.items()}


@create_empty_array.register(Graph)
def _create_empty_array_graph(space: Graph, n: int = 1, fn=np.zeros):
    # Singleton empty graphs (reference space_utils.py:492-513).
    from gymnasium_tpu_torch.spaces.graph import GraphInstance

    if space.edge_space is not None:
        return tuple(
            GraphInstance(
                nodes=fn((1,) + space.node_space.shape, dtype=space.node_space.dtype),
                edges=fn((1,) + space.edge_space.shape, dtype=space.edge_space.dtype),
                edge_links=fn((1, 2), dtype=np.int64),
            )
            for _ in range(n)
        )
    return tuple(
        GraphInstance(
            nodes=fn((1,) + space.node_space.shape, dtype=space.node_space.dtype),
            edges=None,
            edge_links=None,
        )
        for _ in range(n)
    )


@create_empty_array.register(Text)
def _create_empty_array_text(space: Text, n: int = 1, fn=np.zeros) -> tuple[str, ...]:
    return tuple(space.characters[0] * space.min_length for _ in range(n))


@create_empty_array.register(Sequence)
def _create_empty_array_sequence(space: Sequence, n: int = 1, fn=np.zeros):
    if space.stack:
        return tuple(create_empty_array(space.feature_space, n=1, fn=fn) for _ in range(n))
    return tuple(tuple() for _ in range(n))


@create_empty_array.register(OneOf)
def _create_empty_array_oneof(space: OneOf, n: int = 1, fn=np.zeros):
    return tuple(tuple() for _ in range(n))
