"""The port's shared-memory transport against the JAX package's: for each
space, samples written at their index are read back as written, and equal
what the JAX package's functions read after the same writes."""

import multiprocessing as mp

import numpy as np
import pytest

import gymnasium_tpu.spaces as js
from gymnasium_tpu.vector.utils import shared_memory as jshm
from gymnasium_tpu_torch import spaces as ts
from gymnasium_tpu_torch.error import CustomSpaceError
from gymnasium_tpu_torch.vector.utils import create_shared_memory, read_from_shared_memory, write_to_shared_memory
from tests.torch_compare import assert_identical, assert_same, to_port

N = 5

SPACES = {
    "box": lambda: js.Box(-1.0, 1.0, (2, 3), dtype=np.float32),
    "box_f64": lambda: js.Box(-2.0, 2.0, (4,), dtype=np.float64),
    "box_scalar": lambda: js.Box(0, 255, (), dtype=np.uint8),
    "discrete": lambda: js.Discrete(7, start=-2),
    "multi_discrete": lambda: js.MultiDiscrete([3, 5, 2]),
    "multi_binary": lambda: js.MultiBinary((2, 2)),
    "tuple": lambda: js.Tuple((js.Discrete(3), js.Box(0.0, 1.0, (2,)))),
    "dict": lambda: js.Dict({"pos": js.Box(-1.0, 1.0, (3,)), "flag": js.MultiBinary(2),
                             "inner": js.Dict({"k": js.Discrete(4)})}),
    "text": lambda: js.Text(6, min_length=1),
    "oneof": lambda: js.OneOf((js.Discrete(3), js.Box(-1.0, 1.0, (2,)))),
}


@pytest.mark.parametrize("name", sorted(SPACES))
def test_written_values_read_back_and_match_jax(name):
    jspace = SPACES[name]()
    jspace.seed(3)
    space = to_port(jspace)
    samples = [space.sample() for _ in range(N)]
    memory = create_shared_memory(space, n=N, ctx=mp)
    jmemory = jshm.create_shared_memory(jspace, n=N, ctx=mp)
    # write in a scrambled order: each sample lands at its own index
    for index in (3, 0, 4, 1, 2):
        write_to_shared_memory(space, index, samples[index], memory)
        jshm.write_to_shared_memory(jspace, index, samples[index], jmemory)
    got = read_from_shared_memory(space, memory, n=N)
    want = jshm.read_from_shared_memory(jspace, jmemory, n=N)
    assert_identical(got, want)
    for index, sample in enumerate(samples):
        if name == "text":
            assert got[index] == sample
        elif name == "oneof":
            assert got[index][0] == sample[0]
            assert_same(got[index][1], np.asarray(sample[1], dtype=space.spaces[sample[0]].dtype))
        else:
            leaf = _index(got, index)
            assert_same(leaf, _cast(space, sample))


def _index(batch, i):
    if isinstance(batch, dict):
        return {k: _index(v, i) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(_index(v, i) for v in batch)
    return batch[i]


def _cast(space, sample):
    if isinstance(space, ts.Dict):
        return {k: _cast(space[k], sample[k]) for k in space.spaces}
    if isinstance(space, ts.Tuple):
        return tuple(_cast(s, x) for s, x in zip(space.spaces, sample))
    return np.asarray(sample, dtype=space.dtype).reshape(space.shape)


def test_read_is_a_view_of_the_memory():
    space = ts.Box(-1.0, 1.0, (2,), dtype=np.float32)
    memory = create_shared_memory(space, n=3)
    view = read_from_shared_memory(space, memory, n=3)
    write_to_shared_memory(space, 1, np.array([0.25, -0.5], np.float32), memory)
    assert view[1].tolist() == [0.25, -0.5] and view[0].tolist() == [0.0, 0.0]


class Custom(ts.Space):
    pass


@pytest.mark.parametrize("fn", ["create", "read", "write"])
def test_custom_space_raises(fn):
    space = Custom()
    with pytest.raises(CustomSpaceError):
        if fn == "create":
            create_shared_memory(space, n=2)
        elif fn == "read":
            read_from_shared_memory(space, None, n=2)
        else:
            write_to_shared_memory(space, 0, None, None)
    with pytest.raises(TypeError):
        create_shared_memory(object(), n=2)


@pytest.mark.parametrize("space", [ts.Sequence(ts.Discrete(3)),
                                   ts.Graph(ts.Box(0.0, 1.0, (2,)), ts.Discrete(2))], ids=["sequence", "graph"])
def test_dynamic_space_has_no_static_memory(space):
    with pytest.raises(TypeError, match="dynamic shape"):
        create_shared_memory(space, n=2)
