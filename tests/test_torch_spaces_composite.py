"""The port's composite and host-only spaces against the JAX package's.

Host sampling draws from numpy on both sides, so samples from the same seed
are equal exactly, masked or not. Device samples (``sample_torch``) are
checked for shape, dtype and membership, and their statistics against the
uniform law they draw from (the 3-SE and KS gates of
``tests/envs/test_box2d_parity.py``).
"""

import json
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import gymnasium_tpu.spaces as jsp
import gymnasium_tpu_torch.spaces as tsp
from tests.torch_compare import assert_same, assert_same_space

SE_GATE = 3.0
KS_P = 1e-3


def build(sp):
    """The spaces under test, built from the spaces module ``sp``."""
    return {
        "multibinary_8": sp.MultiBinary(8),
        "multibinary_2x3": sp.MultiBinary([2, 3]),
        "multidiscrete_start": sp.MultiDiscrete([3, 4], start=[1, -1]),
        "multidiscrete_2d": sp.MultiDiscrete([[2, 3], [3, 2]]),
        "tuple": sp.Tuple([sp.Discrete(5), sp.Box(low=np.array([0.0, 0.0]), high=np.array([1.0, 5.0]))]),
        "tuple_nested": sp.Tuple((sp.Discrete(5), sp.Tuple((sp.Box(0.0, 1.0, (3,)), sp.MultiBinary(2))))),
        "dict": sp.Dict({"position": sp.Discrete(5), "velocity": sp.Box(low=np.array([0.0, 0.0]), high=np.array([1.0, 5.0]))}),
        "dict_nested": sp.Dict({
            "a": sp.Box(low=0, high=1, shape=(3, 3)),
            "b": sp.Dict({"b_1": sp.Box(-100, 100, (2,)), "b_2": sp.MultiDiscrete([2, 3])}),
            "c": sp.Discrete(4),
        }),
        "text": sp.Text(6),
        "text_charset": sp.Text(min_length=2, max_length=4, charset="abcde"),
        "sequence": sp.Sequence(sp.Discrete(4)),
        "sequence_stacked": sp.Sequence(sp.Box(0.0, 1.0, (3,)), stack=True),
        "graph": sp.Graph(node_space=sp.Box(low=-100, high=100, shape=(3, 4)), edge_space=sp.Discrete(5)),
        "graph_no_edges": sp.Graph(node_space=sp.Discrete(10), edge_space=None),
        "oneof": sp.OneOf([sp.Discrete(3), sp.Box(low=0.0, high=1.0, shape=(2,))]),
    }


NAMES = sorted(build(jsp))


def masks(name):
    """A mask for ``name``'s ``sample`` (the same on both sides), or None."""
    i8 = lambda *v: np.array(v, dtype=np.int8)  # noqa: E731
    return {
        "multibinary_8": i8(0, 1, 2, 2, 2, 1, 0, 2),
        "multibinary_2x3": np.array([[2, 0, 1], [1, 2, 2]], dtype=np.int8),
        "multidiscrete_start": (i8(0, 1, 1), i8(1, 0, 0, 1)),
        "multidiscrete_2d": ((i8(1, 1), i8(0, 1, 1)), (i8(0, 0, 1), i8(1, 0))),
        "tuple": (i8(0, 1, 0, 1, 1), None),
        "dict": {"position": i8(1, 0, 0, 1, 0), "velocity": None},
        "text": (3, None),
        "text_charset": (None, i8(1, 0, 1, 0, 1)),
        "sequence": (np.array([2, 5]), i8(0, 1, 1, 0)),
        "graph": (None, i8(0, 0, 1, 1, 1)),
        "oneof": (i8(0, 1, 1), None),
    }.get(name)


@pytest.fixture(scope="module")
def both():
    return build(tsp), build(jsp)


def draws(space, count, **kwargs):
    return [space.sample(**kwargs) for _ in range(count)]


@pytest.mark.parametrize("name", NAMES)
def test_spaces_equal_jax(both, name):
    port, ref = both[0][name], both[1][name]
    assert_same_space(port, ref)
    assert port.is_np_flattenable == ref.is_np_flattenable
    assert port == build(tsp)[name] and not port == build(tsp)["multibinary_8" if name != "multibinary_8" else "text"]


@pytest.mark.parametrize("name", NAMES)
def test_seed_and_host_samples_equal_jax(both, name):
    port, ref = both[0][name], both[1][name]
    assert port.seed(42) == ref.seed(42)
    assert_same(draws(port, 6), draws(ref, 6))
    assert port.seed(None) is not None


@pytest.mark.parametrize("name", [n for n in NAMES if masks(n) is not None])
def test_masked_host_samples_equal_jax(both, name):
    port, ref = both[0][name], both[1][name]
    port.seed(3), ref.seed(3)
    got, want = draws(port, 8, mask=masks(name)), draws(ref, 8, mask=masks(name))
    assert_same(got, want)
    assert all(port.contains(x) for x in got)


def test_probability_samples_equal_jax(both):
    for name, probability in (
        ("multibinary_8", np.linspace(0.0, 1.0, 8)),
        ("multidiscrete_start", (np.array([0.2, 0.3, 0.5]), np.array([0.1, 0.1, 0.4, 0.4]))),
        ("tuple", (np.full(5, 0.2), None)),
    ):
        port, ref = both[0][name], both[1][name]
        port.seed(5), ref.seed(5)
        assert_same(draws(port, 8, probability=probability), draws(ref, 8, probability=probability))


@pytest.mark.parametrize("name", NAMES)
def test_contains_equals_jax(both, name):
    port, ref = both[0][name], both[1][name]
    port.seed(11), ref.seed(11)
    for x, y in zip(draws(port, 4), draws(ref, 4)):
        assert port.contains(x) and ref.contains(y)
    others = build(jsp)
    for other in NAMES:
        if other == name:
            continue
        sample = others[other].sample()
        assert outcome(port.contains, sample) == outcome(ref.contains, sample), other


def outcome(fn, *args):
    """``fn(*args)``, or the name of the exception it raised."""
    try:
        return fn(*args)
    except Exception as e:  # noqa: BLE001 - the two packages must raise alike
        return type(e).__name__


@pytest.mark.parametrize("name", NAMES)
def test_pickle_round_trip_keeps_space_and_stream(both, name):
    port, ref = both[0][name], both[1][name]
    port.seed(9), ref.seed(9)
    loaded = pickle.loads(pickle.dumps(port))
    assert loaded == port and repr(loaded) == repr(port)
    assert_same(draws(loaded, 3), draws(ref, 3))


@pytest.mark.parametrize("name", NAMES)
def test_jsonable_equals_jax(both, name):
    port, ref = both[0][name], both[1][name]
    port.seed(13), ref.seed(13)
    got, want = draws(port, 3), draws(ref, 3)
    as_json = port.to_jsonable(got)
    ref_json = ref.to_jsonable(want)
    assert json.dumps(as_json, default=str) == json.dumps(ref_json, default=str)
    assert_same(port.from_jsonable(as_json), ref.from_jsonable(ref_json))


def test_multidiscrete_getitem_equals_jax(both):
    for name, index in (("multidiscrete_start", 1), ("multidiscrete_2d", 0), ("multidiscrete_2d", (1, 0))):
        port, ref = both[0][name], both[1][name]
        port.seed(21), ref.seed(21)
        sub, ref_sub = port[index], ref[index]
        assert_same_space(sub, ref_sub)
        assert_same(draws(sub, 5), draws(ref_sub, 5))


# --- device samples ----------------------------------------------------------

N = 4096


def device_spaces(sp):
    return {
        "tuple": sp.Tuple([sp.Box(-1.0, 2.0, (3,)), sp.Discrete(6, start=-2)]),
        "dict": sp.Dict({"u": sp.Box(0.0, 1.0, (2,)), "k": sp.Discrete(4), "m": sp.MultiBinary(3)}),
        "multibinary": sp.MultiBinary([2, 3]),
    }


def _leaves(x):
    if isinstance(x, dict):
        return [leaf for key in x for leaf in _leaves(x[key])]
    if isinstance(x, tuple):
        return [leaf for part in x for leaf in _leaves(part)]
    return [x]


@pytest.mark.parametrize("name", ["tuple", "dict", "multibinary"])
def test_device_samples_shape_dtype_and_membership(name):
    space = device_spaces(tsp)[name]
    gen = torch.Generator().manual_seed(0)
    first, second = space.sample_torch(gen, (N,)), space.sample_torch(gen, (N,))
    want_dtypes = {"tuple": [torch.float32, torch.int32], "dict": [torch.int32, torch.int8, torch.float32],  # keys sorted: k, m, u
                   "multibinary": [torch.int8]}[name]
    assert [leaf.dtype for leaf in _leaves(first)] == want_dtypes
    subspaces = _leaves(space.spaces if name != "multibinary" else space)
    for leaf, sub in zip(_leaves(first), subspaces):
        assert tuple(leaf.shape) == (N,) + sub.shape
    assert bool(space.contains_torch(first)) and bool(space.contains_torch(second))
    assert any(not torch.equal(a, b) for a, b in zip(_leaves(first), _leaves(second)))


def test_device_sample_statistics():
    gen = torch.Generator().manual_seed(4)
    bits = tsp.MultiBinary([2, 3]).sample_torch(gen, (N,)).double()
    se = 0.5 / np.sqrt(N)
    assert (bits.mean(0) - 0.5).abs().max() < SE_GATE * se
    u, k = device_spaces(tsp)["tuple"].sample_torch(gen, (N,))
    for column in range(3):
        assert stats.kstest(u[:, column].numpy(), stats.uniform(loc=-1.0, scale=3.0).cdf).pvalue > KS_P
    counts = np.bincount((k + 2).numpy(), minlength=6) / N
    assert np.abs(counts - 1 / 6).max() < SE_GATE * np.sqrt((1 / 6) * (5 / 6) / N)
    draws_ = device_spaces(tsp)["dict"].sample_torch(gen, (N,))
    assert abs(float(draws_["m"].double().mean()) - 0.5) < SE_GATE * 0.5 / np.sqrt(3 * N)


def test_device_contains_rejects_outside():
    space = device_spaces(tsp)["dict"]
    sample = space.sample_torch(torch.Generator().manual_seed(0), (8,))
    sample["m"][3, 1] = 2
    assert not bool(space.contains_torch(sample))
    t = device_spaces(tsp)["tuple"]
    u, k = t.sample_torch(torch.Generator().manual_seed(0), (8,))
    assert not bool(t.contains_torch((u, k + 10)))


# --- contains of tensors (the port) against contains of jnp arrays (JAX) -----


@pytest.mark.parametrize("value", [1, 0, 2, -1])
def test_discrete_contains_of_a_tensor_equals_jax(value):
    assert tsp.Discrete(2).contains(torch.tensor(value)) == jsp.Discrete(2).contains(jnp.asarray(value))
    assert tsp.Discrete(2).contains(torch.tensor(value, dtype=torch.int32)) == jsp.Discrete(2).contains(
        jnp.asarray(value, dtype=jnp.int32))
    assert tsp.Discrete(2).contains(torch.tensor(float(value))) == jsp.Discrete(2).contains(jnp.asarray(float(value)))


def test_discrete_contains_of_a_tensor_is_true():
    assert tsp.Discrete(2).contains(torch.tensor(1))
    assert jsp.Discrete(2).contains(jnp.asarray(1))
    assert not tsp.Discrete(2).contains(torch.tensor([1]))


def test_box_and_multidiscrete_contains_of_a_tensor_equal_jax():
    box_p, box_j = tsp.Box(-1.0, 1.0, (3,)), jsp.Box(-1.0, 1.0, (3,))
    for values in ([0.0, 0.5, -1.0], [0.0, 1.5, 0.0], [0.0, 0.0]):
        arr = np.asarray(values, np.float32)
        assert box_p.contains(torch.from_numpy(arr)) == box_j.contains(jnp.asarray(arr))
    md_p, md_j = tsp.MultiDiscrete([3, 3]), jsp.MultiDiscrete([3, 3])
    assert md_p.contains(torch.tensor([1, 2])) == md_j.contains(jnp.asarray([1, 2])) is False
