"""The port's space utilities against the JAX package's, on every space of
``tests/spaces/utils.py``'s list.

Each port space is the JAX one read through the port's classes
(``tests.torch_compare.to_port``), so both sides hold the same generator
state and their host samples are equal; every function then gives the same
result on both.
"""

import numpy as np
import pytest

import gymnasium_tpu.spaces.utils as jsu
import gymnasium_tpu.vector.utils as jvu
import gymnasium_tpu_torch.spaces as tsp
import gymnasium_tpu_torch.spaces.utils as tsu
import gymnasium_tpu_torch.vector.utils as tvu
from gymnasium_tpu import spaces as jsp
from tests.spaces.utils import TESTING_SPACES, TESTING_SPACES_IDS
from tests.torch_compare import assert_same, assert_same_space, to_port

N = 3


def pair(space, seed=0):
    """``(port space, JAX space)``, both seeded alike."""
    space.seed(seed)
    return to_port(space), space


def outcome(fn, *args, **kwargs):
    """``fn(...)``, or the name of the exception it raised."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:  # noqa: BLE001 - the two packages must raise alike
        return type(e).__name__


@pytest.mark.parametrize("space", TESTING_SPACES, ids=TESTING_SPACES_IDS)
def test_port_space_is_built_from_the_port(space):
    port, ref = pair(space)
    assert type(port).__module__.startswith("gymnasium_tpu_torch.spaces")
    assert_same_space(port, ref)
    assert_same(port.sample(), ref.sample())


@pytest.mark.parametrize("space", TESTING_SPACES, ids=TESTING_SPACES_IDS)
def test_flatdim_and_flatten_space_equal_jax(space):
    port, ref = pair(space)
    got, want = outcome(tsu.flatdim, port), outcome(jsu.flatdim, ref)
    assert got == want
    flat_port, flat_ref = tsu.flatten_space(port), jsu.flatten_space(ref)
    assert_same_space(flat_port, flat_ref)
    assert tsu.is_space_dtype_shape_equiv(port, port) == jsu.is_space_dtype_shape_equiv(ref, ref)
    assert tsu.is_space_dtype_shape_equiv(port, flat_port) == jsu.is_space_dtype_shape_equiv(ref, flat_ref)


@pytest.mark.parametrize("space", TESTING_SPACES, ids=TESTING_SPACES_IDS)
def test_flatten_and_unflatten_equal_jax(space):
    port, ref = pair(space, seed=5)
    for _ in range(3):
        x, y = port.sample(), ref.sample()
        assert_same(x, y)
        flat_x, flat_y = tsu.flatten(port, x), jsu.flatten(ref, y)
        assert_same(flat_x, flat_y)
        assert_same(tsu.unflatten(port, flat_x), jsu.unflatten(ref, flat_y))


@pytest.mark.parametrize("space", TESTING_SPACES, ids=TESTING_SPACES_IDS)
def test_batch_space_equals_jax(space):
    port, ref = pair(space, seed=2)
    batched_port, batched_ref = tvu.batch_space(port, N), jvu.batch_space(ref, N)
    assert_same_space(batched_port, batched_ref)
    assert_same(batched_port.sample(), batched_ref.sample())


@pytest.mark.parametrize("space", TESTING_SPACES, ids=TESTING_SPACES_IDS)
def test_create_empty_array_concatenate_and_iterate_equal_jax(space):
    port, ref = pair(space, seed=4)
    for fn in (np.zeros, np.ones):
        assert_same(tvu.create_empty_array(port, N, fn=fn), jvu.create_empty_array(ref, N, fn=fn))
    items_port = [port.sample() for _ in range(N)]
    items_ref = [ref.sample() for _ in range(N)]
    assert_same(items_port, items_ref)
    got = tvu.concatenate(port, items_port, tvu.create_empty_array(port, N))
    want = jvu.concatenate(ref, items_ref, jvu.create_empty_array(ref, N))
    assert_same(got, want)
    batched_port, batched_ref = tvu.batch_space(port, N), jvu.batch_space(ref, N)
    assert_same(list(tvu.iterate(batched_port, got)), list(jvu.iterate(batched_ref, want)))


DIFFERING = {
    "boxes": lambda sp: [sp.Box(0.0, 1.0, (2,)), sp.Box(-1.0, 2.0, (2,)), sp.Box(np.array([0.0, -3.0]), 4.0)],
    "discretes": lambda sp: [sp.Discrete(3), sp.Discrete(5, start=-1), sp.Discrete(2, start=4)],
    "multidiscretes": lambda sp: [sp.MultiDiscrete([2, 3]), sp.MultiDiscrete([4, 3], start=[1, 0])],
    "multibinaries": lambda sp: [sp.MultiBinary(4), sp.MultiBinary(4)],
    "tuples": lambda sp: [sp.Tuple([sp.Discrete(2), sp.Box(0.0, 1.0, (1,))]),
                          sp.Tuple([sp.Discrete(3), sp.Box(-1.0, 1.0, (1,))])],
    "dicts": lambda sp: [sp.Dict({"a": sp.Discrete(2), "b": sp.Box(0.0, 1.0)}),
                         sp.Dict({"a": sp.Discrete(4), "b": sp.Box(0.0, 3.0)})],
    "texts": lambda sp: [sp.Text(4), sp.Text(6, charset="abc")],
}


@pytest.mark.parametrize("name", sorted(DIFFERING))
def test_batch_differing_spaces_equals_jax(name):
    port_spaces, ref_spaces = DIFFERING[name](tsp), DIFFERING[name](jsp)
    for i, (a, b) in enumerate(zip(port_spaces, ref_spaces)):
        a.seed(i), b.seed(i)
    got, want = tvu.batch_differing_spaces(port_spaces), jvu.batch_differing_spaces(ref_spaces)
    assert_same_space(got, want)
    assert_same(got.sample(), want.sample())


def test_batch_space_of_box_and_discrete_keeps_its_import_path():
    from gymnasium_tpu_torch.vector.utils import batch_space

    assert batch_space is tvu.batch_space
    assert repr(batch_space(tsp.Discrete(4, start=1), 3)) == repr(jvu.batch_space(jsp.Discrete(4, start=1), 3))
