"""POSIX shared-memory transport for batched observations (copy of the JAX
package's ``vector/utils/shared_memory.py``).

It follows Gymnasium's (gymnasium/vector/utils/shared_memory.py:33-290):
``create_shared_memory`` allocates one ctypes array per leaf space,
``read_from_shared_memory`` wraps it zero-copy as a ``(n, *shape)`` numpy
view, workers ``write_to_shared_memory`` at their index offset.
"""

from __future__ import annotations

import multiprocessing as mp
from ctypes import c_bool
from functools import singledispatch
from typing import Any

import numpy as np

from gymnasium_tpu_torch.error import CustomSpaceError
from gymnasium_tpu_torch.spaces import (
    Box,
    Dict,
    Discrete,
    MultiBinary,
    MultiDiscrete,
    Space,
    Tuple,
    flatdim,
)

__all__ = ["create_shared_memory", "read_from_shared_memory", "write_to_shared_memory"]


@singledispatch
def create_shared_memory(space: Space[Any], n: int = 1, ctx=mp) -> Any:
    """Allocate shared memory for ``n`` samples of ``space``."""
    if isinstance(space, Space):
        raise CustomSpaceError(
            f"Space of type `{type(space)}` doesn't have an registered `create_shared_memory` function. Register `{type(space)}` for `create_shared_memory` to support it."
        )
    raise TypeError(f"The space provided to `create_shared_memory` is not a gymnasium Space instance, type: {type(space)}, {space}")


@create_shared_memory.register(Box)
@create_shared_memory.register(Discrete)
@create_shared_memory.register(MultiDiscrete)
@create_shared_memory.register(MultiBinary)
def _create_base_shared_memory(space, n: int = 1, ctx=mp):
    assert space.dtype is not None
    dtype = space.dtype.char
    if dtype in "?":
        dtype = c_bool
    return ctx.Array(dtype, n * int(np.prod(space.shape)) if space.shape != () else n)


@create_shared_memory.register(Tuple)
def _create_tuple_shared_memory(space: Tuple, n: int = 1, ctx=mp):
    return tuple(create_shared_memory(subspace, n=n, ctx=ctx) for subspace in space.spaces)


@create_shared_memory.register(Dict)
def _create_dict_shared_memory(space: Dict, n: int = 1, ctx=mp):
    return {
        key: create_shared_memory(subspace, n=n, ctx=ctx) for key, subspace in space.items()
    }


@singledispatch
def read_from_shared_memory(space: Space, shared_memory: Any, n: int = 1) -> Any:
    """Zero-copy numpy view over shared memory as a batch of ``n`` samples."""
    if isinstance(space, Space):
        raise CustomSpaceError(
            f"Space of type `{type(space)}` doesn't have an registered `read_from_shared_memory` function. Register `{type(space)}` for `read_from_shared_memory` to support it."
        )
    raise TypeError(f"The space provided to `read_from_shared_memory` is not a gymnasium Space instance, type: {type(space)}, {space}")


@read_from_shared_memory.register(Box)
@read_from_shared_memory.register(Discrete)
@read_from_shared_memory.register(MultiDiscrete)
@read_from_shared_memory.register(MultiBinary)
def _read_base_from_shared_memory(space, shared_memory, n: int = 1):
    return np.frombuffer(shared_memory.get_obj(), dtype=space.dtype).reshape((n,) + space.shape)


@read_from_shared_memory.register(Tuple)
def _read_tuple_from_shared_memory(space: Tuple, shared_memory, n: int = 1):
    return tuple(
        read_from_shared_memory(subspace, memory, n=n)
        for memory, subspace in zip(shared_memory, space.spaces)
    )


@read_from_shared_memory.register(Dict)
def _read_dict_from_shared_memory(space: Dict, shared_memory, n: int = 1):
    return {
        key: read_from_shared_memory(subspace, shared_memory[key], n=n)
        for key, subspace in space.items()
    }


@singledispatch
def write_to_shared_memory(space: Space, index: int, value: np.ndarray, shared_memory: Any):
    """Write one sample into the shared batch at position ``index``."""
    if isinstance(space, Space):
        raise CustomSpaceError(
            f"Space of type `{type(space)}` doesn't have an registered `write_to_shared_memory` function. Register `{type(space)}` for `write_to_shared_memory` to support it."
        )
    raise TypeError(f"The space provided to `write_to_shared_memory` is not a gymnasium Space instance, type: {type(space)}, {space}")


@write_to_shared_memory.register(Box)
@write_to_shared_memory.register(Discrete)
@write_to_shared_memory.register(MultiDiscrete)
@write_to_shared_memory.register(MultiBinary)
def _write_base_to_shared_memory(space, index: int, value, shared_memory):
    size = int(np.prod(space.shape)) if space.shape != () else 1
    destination = np.frombuffer(shared_memory.get_obj(), dtype=space.dtype)
    np.copyto(
        destination[index * size : (index + 1) * size],
        np.asarray(value, dtype=space.dtype).flatten(),
    )


@write_to_shared_memory.register(Tuple)
def _write_tuple_to_shared_memory(space: Tuple, index: int, values, shared_memory):
    for value, memory, subspace in zip(values, shared_memory, space.spaces):
        write_to_shared_memory(subspace, index, value, memory)


@write_to_shared_memory.register(Dict)
def _write_dict_to_shared_memory(space: Dict, index: int, values, shared_memory):
    for key, subspace in space.items():
        write_to_shared_memory(subspace, index, values[key], shared_memory[key])


# --- variable/tagged spaces (reference shared_memory.py:90-106, 171-205, 272-290)


from gymnasium_tpu_torch.spaces import Graph, OneOf, Sequence, Text  # noqa: E402
from gymnasium_tpu_torch.spaces.utils import flatten  # noqa: E402


@create_shared_memory.register(Text)
def _create_text_shared_memory(space: Text, n: int = 1, ctx=mp):
    return ctx.Array(np.dtype(np.int32).char, n * space.max_length)


@create_shared_memory.register(OneOf)
def _create_oneof_shared_memory(space: OneOf, n: int = 1, ctx=mp):
    return (ctx.Array(np.dtype(np.int64).char, n),) + tuple(
        create_shared_memory(subspace, n=n, ctx=ctx) for subspace in space.spaces
    )


@create_shared_memory.register(Graph)
@create_shared_memory.register(Sequence)
def _create_dynamic_shared_memory(space, n: int = 1, ctx=mp):
    raise TypeError(
        f"As {space} has a dynamic shape so its not possible to make a static shared memory. For `AsyncVectorEnv`, disable `shared_memory`."
    )


@read_from_shared_memory.register(Text)
def _read_text_from_shared_memory(space: Text, shared_memory, n: int = 1):
    data = np.frombuffer(shared_memory.get_obj(), dtype=np.int32).reshape(
        (n, space.max_length)
    )
    return tuple(
        "".join(
            space.character_list[val]
            for val in values
            if val < len(space.character_set)
        )
        for values in data
    )


@read_from_shared_memory.register(OneOf)
def _read_oneof_from_shared_memory(space: OneOf, shared_memory, n: int = 1):
    sample_indexes = np.frombuffer(shared_memory[0].get_obj(), dtype=np.int64)
    subspace_samples = tuple(
        read_from_shared_memory(subspace, memory, n=n)
        for memory, subspace in zip(shared_memory[1:], space.spaces)
    )
    return tuple(
        (index, subspace_samples[index][env])
        for env, index in enumerate(sample_indexes)
    )


@write_to_shared_memory.register(Text)
def _write_text_to_shared_memory(space: Text, index: int, values: str, shared_memory):
    size = space.max_length
    destination = np.frombuffer(shared_memory.get_obj(), dtype=np.int32)
    np.copyto(destination[index * size : (index + 1) * size], flatten(space, values))


@write_to_shared_memory.register(OneOf)
def _write_oneof_to_shared_memory(space: OneOf, index: int, values, shared_memory):
    subspace_idx, space_value = values
    destination = np.frombuffer(shared_memory[0].get_obj(), dtype=np.int64)
    np.copyto(destination[index : index + 1], subspace_idx)
    # only the chosen subspace's memory is written; others may hold stale data
    write_to_shared_memory(
        space.spaces[int(subspace_idx)], index, space_value, shared_memory[1 + int(subspace_idx)]
    )
