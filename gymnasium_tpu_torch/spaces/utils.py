"""Flatten/unflatten utilities over the space zoo.

Copy of the JAX package's ``spaces/utils.py`` (``flatdim``, ``flatten`` with
one-hot encoding for Discrete/MultiDiscrete, ``unflatten``, ``flatten_space``,
``is_space_dtype_shape_equiv``), ``singledispatch`` over the space types.
Samples are host values: ``flatten`` returns numpy arrays.
"""

from __future__ import annotations

import operator
from functools import reduce, singledispatch
from typing import Any, TypeVar

import numpy as np

from gymnasium_tpu_torch.spaces.box import Box
from gymnasium_tpu_torch.spaces.dict import Dict
from gymnasium_tpu_torch.spaces.discrete import Discrete
from gymnasium_tpu_torch.spaces.graph import Graph, GraphInstance
from gymnasium_tpu_torch.spaces.multi_binary import MultiBinary
from gymnasium_tpu_torch.spaces.multi_discrete import MultiDiscrete
from gymnasium_tpu_torch.spaces.oneof import OneOf
from gymnasium_tpu_torch.spaces.sequence import Sequence
from gymnasium_tpu_torch.spaces.space import Space
from gymnasium_tpu_torch.spaces.text import Text
from gymnasium_tpu_torch.spaces.tuple import Tuple

__all__ = ["flatdim", "flatten", "unflatten", "flatten_space", "is_space_dtype_shape_equiv"]

T = TypeVar("T")


# --- flatdim --------------------------------------------------------------


@singledispatch
def flatdim(space: Space[Any]) -> int:
    """Number of dimensions a flattened equivalent of ``space`` has.

    Raises ``ValueError`` for spaces whose flat size is not fixed
    (``Graph``, ``Sequence``, non-flattenable composites),
    ``NotImplementedError`` for unknown space types — matching the reference
    (gymnasium/spaces/utils.py:35-46).
    """
    if isinstance(space, Space) and not space.is_np_flattenable:
        raise ValueError(
            f"{space} cannot be flattened to a numpy array, probably because it contains a `Graph` or `Sequence` subspace"
        )
    raise NotImplementedError(f"Unknown space: `{space}`")


@flatdim.register(Box)
@flatdim.register(MultiBinary)
def _flatdim_box(space: Box | MultiBinary) -> int:
    return reduce(operator.mul, space.shape, 1)


@flatdim.register(Discrete)
def _flatdim_discrete(space: Discrete) -> int:
    return int(space.n)


@flatdim.register(MultiDiscrete)
def _flatdim_multidiscrete(space: MultiDiscrete) -> int:
    return int(np.sum(space.nvec))


@flatdim.register(Tuple)
def _flatdim_tuple(space: Tuple) -> int:
    if space.is_np_flattenable:
        return sum(flatdim(s) for s in space.spaces)
    raise ValueError(f"{space} cannot be flattened to a numpy array, probably because it contains a `Graph` or `Sequence` subspace")


@flatdim.register(Dict)
def _flatdim_dict(space: Dict) -> int:
    if space.is_np_flattenable:
        return sum(flatdim(s) for s in space.spaces.values())
    raise ValueError(f"{space} cannot be flattened to a numpy array, probably because it contains a `Graph` or `Sequence` subspace")


@flatdim.register(Graph)
def _flatdim_graph(space: Graph):
    raise ValueError("Cannot get flattened size as the Graph Space in Gym has a dynamic size, so please use `flatten_space`.")


@flatdim.register(Text)
def _flatdim_text(space: Text) -> int:
    return space.max_length


@flatdim.register(OneOf)
def _flatdim_oneof(space: OneOf) -> int:
    return 1 + max(flatdim(s) for s in space.spaces)


# --- flatten --------------------------------------------------------------


@singledispatch
def flatten(space: Space[Any], x: Any) -> Any:
    """Flatten a sample ``x`` of ``space`` into a 1-D representation."""
    raise NotImplementedError(f"Unknown space: `{space}`")


@flatten.register(Box)
@flatten.register(MultiBinary)
def _flatten_box(space: Box | MultiBinary, x) -> np.ndarray:
    return np.asarray(x, dtype=space.dtype).flatten()


@flatten.register(Discrete)
def _flatten_discrete(space: Discrete, x) -> np.ndarray:
    onehot = np.zeros(int(space.n), dtype=space.dtype)
    onehot[int(x) - int(space.start)] = 1
    return onehot


@flatten.register(MultiDiscrete)
def _flatten_multidiscrete(space: MultiDiscrete, x) -> np.ndarray:
    # offsets accumulate in int_ — small space dtypes (int8) overflow on cumsum
    offsets = np.zeros(space.nvec.size + 1, dtype=np.int_)
    offsets[1:] = np.cumsum(space.nvec.flatten())
    onehot = np.zeros((offsets[-1],), dtype=space.dtype)
    shifted = (np.asarray(x, dtype=np.int_) - space.start).flatten()
    onehot[offsets[:-1] + shifted] = 1
    return onehot


@flatten.register(Tuple)
def _flatten_tuple(space: Tuple, x) -> np.ndarray | tuple[Any, ...]:
    if space.is_np_flattenable:
        return np.concatenate([flatten(s, xp) for xp, s in zip(x, space.spaces)])
    return tuple(flatten(s, xp) for xp, s in zip(x, space.spaces))


@flatten.register(Dict)
def _flatten_dict(space: Dict, x) -> np.ndarray | dict[str, Any]:
    if space.is_np_flattenable:
        return np.concatenate([flatten(s, x[key]) for key, s in space.spaces.items()])
    return {key: flatten(s, x[key]) for key, s in space.spaces.items()}


@flatten.register(Graph)
def _flatten_graph(space: Graph, x: GraphInstance) -> GraphInstance:
    def _graph_unflatten_features(sub_space, feats):
        if sub_space is None or feats is None:
            return None
        if isinstance(sub_space, Box):
            return np.asarray(feats, dtype=sub_space.dtype).reshape(feats.shape[0], -1)
        # Discrete features -> one-hot rows
        onehot = np.zeros((feats.shape[0], int(sub_space.n)), dtype=sub_space.dtype)
        onehot[np.arange(feats.shape[0]), np.asarray(feats) - int(sub_space.start)] = 1
        return onehot

    nodes = _graph_unflatten_features(space.node_space, x.nodes)
    edges = _graph_unflatten_features(space.edge_space, x.edges)
    return GraphInstance(nodes, edges, x.edge_links)


@flatten.register(Text)
def _flatten_text(space: Text, x: str) -> np.ndarray:
    arr = np.full(shape=(space.max_length,), fill_value=len(space.character_set), dtype=np.int32)
    for i, char in enumerate(x):
        arr[i] = space.character_index(char)
    return arr


@flatten.register(Sequence)
def _flatten_sequence(space: Sequence, x) -> tuple[Any, ...] | Any:
    if space.stack:
        from gymnasium_tpu_torch.vector.utils import iterate

        samples = [flatten(space.feature_space, item) for item in iterate(space.stacked_feature_space, x)]
        if len(samples) == 0:
            from gymnasium_tpu_torch.vector.utils import create_empty_array

            return create_empty_array(flatten_space(space.feature_space), 0)
        return np.stack(samples)
    return tuple(flatten(space.feature_space, item) for item in x)


@flatten.register(OneOf)
def _flatten_oneof(space: OneOf, x: tuple[int, Any]) -> np.ndarray:
    idx, sample = x
    sub_space = space.spaces[int(idx)]
    flat_sample = np.asarray(flatten(sub_space, sample), dtype=np.float64).flatten()
    max_len = max(flatdim(s) for s in space.spaces)
    padded = np.zeros(1 + max_len, dtype=np.float64)
    padded[0] = float(idx)
    padded[1 : 1 + flat_sample.size] = flat_sample
    return padded


# --- unflatten ------------------------------------------------------------


@singledispatch
def unflatten(space: Space[T], x: Any) -> T:
    """Inverse of :func:`flatten`."""
    raise NotImplementedError(f"Unknown space: `{space}`")


@unflatten.register(Box)
@unflatten.register(MultiBinary)
def _unflatten_box(space: Box | MultiBinary, x: np.ndarray):
    return np.asarray(x, dtype=space.dtype).reshape(space.shape)


@unflatten.register(Discrete)
def _unflatten_discrete(space: Discrete, x: np.ndarray):
    nonzero = np.nonzero(x)[0]
    if len(nonzero) == 0:
        raise ValueError(f"{x} is not a valid one-hot encoded vector; no positions are 1")
    return space.start + space.dtype.type(nonzero[0])


@unflatten.register(MultiDiscrete)
def _unflatten_multidiscrete(space: MultiDiscrete, x: np.ndarray):
    offsets = np.zeros(space.nvec.size + 1, dtype=np.int_)
    offsets[1:] = np.cumsum(space.nvec.flatten())
    nonzero = np.nonzero(x)[0]
    if len(nonzero) != space.nvec.size:
        raise ValueError(f"{x} is not a concatenation of one-hot encoded vectors for nvec {space.nvec}")
    indices = nonzero - offsets[:-1]
    return (indices.reshape(space.shape) + space.start).astype(space.dtype)


@unflatten.register(Tuple)
def _unflatten_tuple(space: Tuple, x):
    if space.is_np_flattenable:
        dims = np.asarray([flatdim(s) for s in space.spaces])
        list_flattened = np.split(np.asarray(x), np.cumsum(dims[:-1]))
        return tuple(unflatten(s, flat) for flat, s in zip(list_flattened, space.spaces))
    return tuple(unflatten(s, xp) for xp, s in zip(x, space.spaces))


@unflatten.register(Dict)
def _unflatten_dict(space: Dict, x):
    if space.is_np_flattenable:
        dims = np.asarray([flatdim(s) for s in space.spaces.values()])
        list_flattened = np.split(np.asarray(x), np.cumsum(dims[:-1]))
        return {
            key: unflatten(s, flat)
            for flat, (key, s) in zip(list_flattened, space.spaces.items())
        }
    return {key: unflatten(s, x[key]) for key, s in space.spaces.items()}


@unflatten.register(Graph)
def _unflatten_graph(space: Graph, x: GraphInstance) -> GraphInstance:
    def _unflatten_features(sub_space, feats):
        if sub_space is None or feats is None:
            return None
        if isinstance(sub_space, Box):
            return np.asarray(feats, dtype=sub_space.dtype).reshape((feats.shape[0],) + sub_space.shape)
        return np.asarray(np.nonzero(feats)[-1], dtype=sub_space.dtype) + int(sub_space.start)

    nodes = _unflatten_features(space.node_space, x.nodes)
    edges = _unflatten_features(space.edge_space, x.edges)
    return GraphInstance(nodes, edges, x.edge_links)


@unflatten.register(Text)
def _unflatten_text(space: Text, x: np.ndarray) -> str:
    return "".join(
        space.character_list[val] for val in x if val < len(space.character_set)
    )


@unflatten.register(Sequence)
def _unflatten_sequence(space: Sequence, x):
    if space.stack:
        from gymnasium_tpu_torch.vector.utils import concatenate, create_empty_array, iterate

        flat_feature = flatten_space(space.feature_space)
        items = [
            unflatten(space.feature_space, item)
            for item in np.asarray(x)
        ]
        out = create_empty_array(space.feature_space, len(items))
        return concatenate(space.feature_space, items, out)
    return tuple(unflatten(space.feature_space, item) for item in x)


@unflatten.register(OneOf)
def _unflatten_oneof(space: OneOf, x: np.ndarray):
    idx = int(x[0])
    sub_space = space.spaces[idx]
    flat = x[1 : 1 + flatdim(sub_space)]
    return (np.int64(idx), unflatten(sub_space, flat))


# --- flatten_space --------------------------------------------------------


@singledispatch
def flatten_space(space: Space[Any]) -> Space[Any]:
    """The space that :func:`flatten` maps samples of ``space`` into."""
    raise NotImplementedError(f"Unknown space: `{space}`")


@flatten_space.register(Box)
def _flatten_space_box(space: Box) -> Box:
    return Box(space.low.flatten(), space.high.flatten(), dtype=space.dtype)


@flatten_space.register(Discrete)
def _flatten_space_discrete(space: Discrete) -> Box:
    return Box(low=0, high=1, shape=(int(space.n),), dtype=space.dtype)


@flatten_space.register(MultiDiscrete)
def _flatten_space_multidiscrete(space: MultiDiscrete) -> Box:
    return Box(low=0, high=1, shape=(int(np.sum(space.nvec)),), dtype=space.dtype)


@flatten_space.register(MultiBinary)
def _flatten_space_multibinary(space: MultiBinary) -> Box:
    return Box(low=0, high=1, shape=(flatdim(space),), dtype=space.dtype)


@flatten_space.register(Tuple)
def _flatten_space_tuple(space: Tuple) -> Box | Tuple:
    if space.is_np_flattenable:
        flat = [flatten_space(s) for s in space.spaces]
        return Box(
            low=np.concatenate([np.broadcast_to(f.low, f.shape).astype(np.float64) for f in flat]),
            high=np.concatenate([np.broadcast_to(f.high, f.shape).astype(np.float64) for f in flat]),
            dtype=np.result_type(*[f.dtype for f in flat]),
        )
    return Tuple(flatten_space(s) for s in space.spaces)


@flatten_space.register(Dict)
def _flatten_space_dict(space: Dict) -> Box | Dict:
    if space.is_np_flattenable:
        flat = [flatten_space(s) for s in space.spaces.values()]
        return Box(
            low=np.concatenate([np.broadcast_to(f.low, f.shape).astype(np.float64) for f in flat]),
            high=np.concatenate([np.broadcast_to(f.high, f.shape).astype(np.float64) for f in flat]),
            dtype=np.result_type(*[f.dtype for f in flat]),
        )
    return Dict({key: flatten_space(s) for key, s in space.spaces.items()})


@flatten_space.register(Graph)
def _flatten_space_graph(space: Graph) -> Graph:
    return Graph(
        node_space=flatten_space(space.node_space),
        edge_space=flatten_space(space.edge_space) if space.edge_space is not None else None,
    )


@flatten_space.register(Text)
def _flatten_space_text(space: Text) -> Box:
    return Box(low=0, high=len(space.character_set), shape=(space.max_length,), dtype=np.int32)


@flatten_space.register(Sequence)
def _flatten_space_sequence(space: Sequence) -> Sequence:
    return Sequence(flatten_space(space.feature_space), stack=space.stack)


@flatten_space.register(OneOf)
def _flatten_space_oneof(space: OneOf) -> Box:
    num_subspaces = len(space.spaces)
    max_flatdim = max(flatdim(s) for s in space.spaces) + 1
    lows = np.array([np.min(np.broadcast_to(flatten_space(s).low, (flatdim(s),))) for s in space.spaces])
    highs = np.array([np.max(np.broadcast_to(flatten_space(s).high, (flatdim(s),))) for s in space.spaces])
    overall_low = np.min(lows)
    overall_high = np.max(highs)
    low = np.concatenate([[0], np.full(max_flatdim - 1, overall_low)])
    high = np.concatenate([[num_subspaces - 1], np.full(max_flatdim - 1, overall_high)])
    return Box(low=low, high=high, shape=(max_flatdim,), dtype=np.float64)


# --- structural equivalence ----------------------------------------------


def is_space_dtype_shape_equiv(space_1: Space, space_2: Space) -> bool:
    """True when two spaces share dtype + shape structure, per-type
    (reference spaces/utils.py:583-680; vector envs use this to decide
    whether differing sub-env spaces can share one batch buffer)."""
    if type(space_1) is not type(space_2):
        return False
    if isinstance(space_1, (Box, Discrete, MultiDiscrete, MultiBinary)):
        return space_1.shape == space_2.shape and space_1.dtype == space_2.dtype
    if isinstance(space_1, Text):
        return (
            space_1.max_length == space_2.max_length
            and space_1.character_set == space_2.character_set
        )
    if isinstance(space_1, Dict):
        return space_1.keys() == space_2.keys() and all(
            is_space_dtype_shape_equiv(space_1[key], space_2[key])
            for key in space_1.keys()
        )
    if isinstance(space_1, (Tuple, OneOf)):
        return len(space_1) == len(space_2) and all(
            is_space_dtype_shape_equiv(a, b)
            for a, b in zip(space_1.spaces, space_2.spaces)
        )
    if isinstance(space_1, Graph):
        return is_space_dtype_shape_equiv(space_1.node_space, space_2.node_space) and (
            (space_1.edge_space is None and space_2.edge_space is None)
            or (
                space_1.edge_space is not None
                and space_2.edge_space is not None
                and is_space_dtype_shape_equiv(space_1.edge_space, space_2.edge_space)
            )
        )
    if isinstance(space_1, Sequence):
        return space_1.stack is space_2.stack and is_space_dtype_shape_equiv(
            space_1.feature_space, space_2.feature_space
        )
    raise NotImplementedError(
        "`check_dtype_shape_equivalence` doesn't support Generic Gymnasium Spaces, "
    )
