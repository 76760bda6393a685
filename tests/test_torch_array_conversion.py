"""The port's array conversion against the JAX package's.

``array_conversion`` to torch and to numpy gives JAX's result for nested
values (dicts, tuples, NamedTuples, lists; python and numpy numbers; 0-d
arrays; bool, int32, int64, float32, float64 and uint8): the same container
types, dtypes and values. ``NumpyToTorch`` over ``make("CartPole-v1")`` and
the vector ``NumpyToTorch`` over ``make_vec("CartPole-v1", 4, "sync")`` give
JAX's outputs step for step; the port's puts its tensors on ``device``,
where JAX's ignores it. ``ArrayConversion(env, "torch", "numpy")`` reads a
device env's tensors back as numpy. The jax-named names resolve and raise
``DependencyNotInstalled``.
"""

import pickle
from typing import NamedTuple

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu.wrappers as jw
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers as tw
from gymnasium_tpu.wrappers.array_conversion import array_conversion as jconvert
from gymnasium_tpu_torch.error import DependencyNotInstalled
from gymnasium_tpu_torch.utils.device import to_host
from gymnasium_tpu_torch.wrappers.array_conversion import array_conversion, module_namespace
from tests.torch_compare import assert_identical, assert_same


class Pair(NamedTuple):
    left: object
    right: object


DTYPES = (np.bool_, np.int32, np.int64, np.float32, np.float64, np.uint8)


def values() -> dict:
    rng = np.random.default_rng(0)
    arrays = {np.dtype(d).name: (rng.integers(0, 2, (2, 3)) if d is np.bool_ else rng.normal(size=(2, 3)) * 50).astype(d)
              for d in DTYPES}
    return {
        **{f"array[{name}]": a for name, a in arrays.items()},
        **{f"0-d[{np.dtype(d).name}]": np.asarray(3, dtype=d) for d in DTYPES},
        **{f"scalar[{np.dtype(d).name}]": d(1) for d in DTYPES},
        "python_int": 7,
        "python_float": 2.5,
        "python_bool": True,
        "dict": {"obs": arrays["float32"], "count": 3, "flags": arrays["bool"]},
        "tuple": (arrays["int64"], 1.5, (arrays["uint8"], np.float64(0.25))),
        "namedtuple": Pair(arrays["int32"], Pair(np.int64(4), [arrays["float64"]])),
        "list": [arrays["float32"], {"inner": arrays["int32"]}, 9],
        "none_and_text": {"none": None, "text": "kept"},
    }


VALUES = values()


def assert_converted(got, want, path="x"):
    """Both conversions hold the same containers, and each leaf is a tensor
    of the same dtype and values (or the same non-array leaf)."""
    assert type(got) is type(want), f"{path}: {type(got)} vs {type(want)}"
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for key in want:
            assert_converted(got[key], want[key], f"{path}[{key!r}]")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            assert_converted(a, b, f"{path}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape and got.device == want.device, path
        assert torch.equal(got, want), path
    else:
        assert_identical(got, want, path)


@pytest.mark.parametrize("name", sorted(VALUES))
def test_numpy_to_torch_equals_jax(name):
    assert_converted(array_conversion(VALUES[name], torch), jconvert(VALUES[name], torch))


@pytest.mark.parametrize("name", sorted(VALUES))
def test_torch_to_numpy_equals_jax(name):
    tensors = jconvert(VALUES[name], torch)
    got, want = array_conversion(tensors, np), jconvert(tensors, np)
    assert_identical(got, want)


def test_namespaces_resolve_by_name():
    assert module_namespace("numpy") is module_namespace("np") is np
    assert module_namespace("torch") is torch
    with pytest.raises(ValueError, match="Unknown array namespace: cupy"):
        module_namespace("cupy")


def test_conversion_to_torch_puts_tensors_on_the_device():
    got = array_conversion(VALUES["dict"], torch, "meta")
    assert all(t.device.type == "meta" for t in (got["obs"], got["count"], got["flags"]))
    assert got["obs"].dtype == torch.float32 and got["count"].dtype == torch.int64


# --- the wrappers ----------------------------------------------------------------


def wrapper_spec(entry):
    return entry.name, entry.entry_point.replace("gymnasium_tpu_torch.", "gymnasium_tpu.", 1), entry.kwargs


def test_numpy_to_torch_wrapper_equals_jax_over_40_steps():
    port = tw.NumpyToTorch(gym.make("CartPole-v1"))
    ref = jw.NumpyToTorch(jgym.make("CartPole-v1"))
    assert [wrapper_spec(w) for w in port.spec.additional_wrappers] == \
        [wrapper_spec(w) for w in ref.spec.additional_wrappers]
    assert port.device is None and ref.device is None
    got, want = port.reset(seed=0), ref.reset(seed=0)
    assert_converted(got, want)
    rng = np.random.default_rng(1)
    for k in range(40):
        action = torch.as_tensor(rng.integers(0, 2))
        got, want = port.step(action), ref.step(action)
        assert_converted(got, want, f"step {k}")
        if want[2] or want[3]:
            assert_converted(port.reset(), ref.reset(), f"reset after step {k}")
    port.close()
    ref.close()


def test_vector_numpy_to_torch_equals_jax_over_20_steps():
    port = tw.vector.NumpyToTorch(gym.make_vec("CartPole-v1", 4, vectorization_mode="sync"))
    ref = jw.vector.NumpyToTorch(jgym.make_vec("CartPole-v1", 4, vectorization_mode="sync"))
    assert_converted(port.reset(seed=0), ref.reset(seed=0))
    rng = np.random.default_rng(2)
    for k in range(20):
        actions = torch.as_tensor(rng.integers(0, 2, 4))
        assert_converted(port.step(actions), ref.step(actions), f"step {k}")
    port.close()
    ref.close()


@pytest.mark.parametrize("vector", [False, True], ids=["single", "vector"])
def test_numpy_to_torch_honours_its_device(vector):
    if vector:
        env = tw.vector.NumpyToTorch(gym.make_vec("CartPole-v1", 2, vectorization_mode="sync"), device="meta")
    else:
        env = tw.NumpyToTorch(gym.make("CartPole-v1"), device="meta")
    obs, info = env.reset(seed=0)
    assert obs.device.type == "meta" and env.device == "meta"
    out = env.step(torch.zeros(2, dtype=torch.int64) if vector else torch.tensor(0))
    assert out[0].device.type == "meta"
    env.close()


def test_array_conversion_reads_a_device_env_back_as_numpy():
    bare = gym.make("phys2d/CartPole-v1", device="cpu")
    env = tw.ArrayConversion(gym.make("phys2d/CartPole-v1", device="cpu"), env_xp="torch", target_xp="numpy")
    obs, info = env.reset(seed=3)
    want_obs, _ = bare.reset(seed=3)
    assert isinstance(obs, np.ndarray) and isinstance(want_obs, torch.Tensor)
    assert_identical(obs, to_host(want_obs))
    for k in range(30):
        action = np.int64(k % 2)
        got, want = env.step(action), bare.step(action)
        assert isinstance(got[0], np.ndarray)
        assert_identical(got[0], to_host(want[0]), f"step {k}")
        assert_identical(got[1:4], (float(want[1]), bool(want[2]), bool(want[3])), f"step {k}")
        if want[2]:
            assert_identical(env.reset()[0], to_host(bare.reset()[0]), f"reset after step {k}")


def test_vector_array_conversion_reads_a_torch_vector_env_back_as_numpy():
    bare = gym.make_vec("CartPole-v1", 8, vectorization_mode="torch", vector_kwargs={"device": "cpu"})
    env = tw.vector.ArrayConversion(gym.make_vec("CartPole-v1", 8, vectorization_mode="torch",
                                                 vector_kwargs={"device": "cpu"}), "torch", "numpy")
    got, want = env.reset(seed=0), bare.reset(seed=0)
    assert_identical(got[0], to_host(want[0]))
    for k in range(12):
        actions = np.arange(8) % 2
        got, want = env.step(actions), bare.step(torch.as_tensor(actions))
        for a, b in zip(got[:4], want[:4]):
            assert isinstance(a, np.ndarray)
            assert_identical(a, to_host(b), f"step {k}")
    env.close()
    bare.close()


def test_pickled_wrappers_step_as_before():
    env = tw.NumpyToTorch(gym.make("CartPole-v1"), device=torch.device("cpu"))
    env.reset(seed=0)
    copy = pickle.loads(pickle.dumps(env))
    assert copy.device == "cpu" and copy._target_xp is torch and copy._env_xp is np
    for k in range(10):
        assert_converted(copy.step(torch.tensor(k % 2)), env.step(torch.tensor(k % 2)), f"step {k}")

    env = tw.ArrayConversion(gym.make("phys2d/CartPole-v1", device="cpu"), "torch", "numpy")
    env.reset(seed=5)
    copy = pickle.loads(pickle.dumps(env))
    for k in range(10):
        assert_identical(copy.step(np.int64(1)), env.step(np.int64(1)), f"step {k}")


# --- the jax-named names -----------------------------------------------------------

JAX_NAMED = {
    "wrappers.JaxToNumpy": lambda: tw.JaxToNumpy(gym.make("CartPole-v1")),
    "wrappers.JaxToTorch": lambda: tw.JaxToTorch(gym.make("CartPole-v1")),
    "wrappers.vector.JaxToNumpy": lambda: tw.vector.JaxToNumpy(gym.make_vec("CartPole-v1", 2, "sync")),
    "wrappers.vector.JaxToTorch": lambda: tw.vector.JaxToTorch(gym.make_vec("CartPole-v1", 2, "sync")),
    "jax_to_numpy": lambda: __import__("gymnasium_tpu_torch.wrappers.jax_to_numpy", fromlist=["x"]).jax_to_numpy(1),
    "numpy_to_jax": lambda: __import__("gymnasium_tpu_torch.wrappers.jax_to_numpy", fromlist=["x"]).numpy_to_jax(1),
    "jax_to_torch": lambda: __import__("gymnasium_tpu_torch.wrappers.jax_to_torch", fromlist=["x"]).jax_to_torch(1),
    "torch_to_jax": lambda: __import__("gymnasium_tpu_torch.wrappers.jax_to_torch", fromlist=["x"]).torch_to_jax(1),
    "module_namespace('jax')": lambda: module_namespace("jax"),
    "ArrayConversion(env_xp='jnp')": lambda: tw.ArrayConversion(gym.make("CartPole-v1"), "jnp", "numpy"),
}


@pytest.mark.parametrize("name", sorted(JAX_NAMED))
def test_jax_named_conversion_raises_dependency_not_installed(name):
    with pytest.raises(DependencyNotInstalled, match=r'needs JAX.*ArrayConversion\(env, env_xp="torch"'):
        JAX_NAMED[name]()


@pytest.mark.parametrize("module", ["jax_to_numpy", "jax_to_torch", "numpy_to_torch", "array_conversion"])
def test_module_all_equals_jax(module):
    import importlib

    got = importlib.import_module(f"gymnasium_tpu_torch.wrappers.{module}").__all__
    assert got == importlib.import_module(f"gymnasium_tpu.wrappers.{module}").__all__


@pytest.mark.parametrize("catalog", ["wrappers", "wrappers.vector"])
def test_every_catalog_name_resolves_to_the_port(catalog):
    import importlib

    port = importlib.import_module(f"gymnasium_tpu_torch.{catalog}")
    ref = importlib.import_module(f"gymnasium_tpu.{catalog}")
    assert port.__all__ == ref.__all__
    for name in port.__all__:
        value = getattr(port, name)
        assert getattr(value, "__module__", getattr(value, "__name__", "")).startswith("gymnasium_tpu_torch."), name
