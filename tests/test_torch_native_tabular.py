"""The port's native tabular stepper and ``NativeTabularVectorEnv`` against
the JAX package's.

The port keeps its own copy of ``native/tabular.cpp`` (equal byte for byte
to the JAX package's), builds it with ``g++`` into the package's
``build/`` directory, and its compiled and numpy paths step alike. Each of
the four ``vector_entry_point`` ids gives JAX's states, rewards and flags in
every bit over 500 steps at 64 envs: both draw their uniforms from the
env's PCG64 generator.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.native import TabularBatchStepper, tabular_library
from gymnasium_tpu_torch.native.build import BUILD_DIR, SOURCE_DIR, build_library, library_path
from gymnasium_tpu_torch.vector.native_tabular import NativeTabularVectorEnv
from tests.torch_compare import assert_identical

ROOT = Path(__file__).resolve().parent.parent
IDS = ("FrozenLake-v1", "FrozenLake8x8-v1", "CliffWalking-v1", "Taxi-v3")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="needs the host g++")


def test_source_is_the_jax_package_copy_byte_for_byte():
    port = (ROOT / "gymnasium_tpu_torch" / "native" / "tabular.cpp").read_bytes()
    assert port == (ROOT / "gymnasium_tpu" / "native" / "tabular.cpp").read_bytes()
    assert SOURCE_DIR == ROOT / "gymnasium_tpu_torch" / "native"


@needs_gxx
def test_library_is_built_under_the_package_build_directory():
    lib = tabular_library()
    assert lib is not None
    path = Path(lib._name)
    assert path == library_path("gymtpu_tabular", ["tabular.cpp"]) and path.exists()
    assert path.parent == BUILD_DIR == ROOT / "gymnasium_tpu_torch" / "build"
    assert not list(SOURCE_DIR.glob("*.so"))


@needs_gxx
def test_rebuild_from_a_copied_source(tmp_path):
    shutil.copy(SOURCE_DIR / "tabular.cpp", tmp_path / "tabular.cpp")
    lib = build_library("tabular_copy", ["tabular.cpp"], source_dir=tmp_path, build_dir=tmp_path / "out")
    assert lib is not None and Path(lib._name).parent == tmp_path / "out"
    assert hasattr(lib, "tabular_step_batch") and hasattr(lib, "tabular_rollout_batch")


def test_failed_build_falls_back_to_none(tmp_path):
    (tmp_path / "broken.cpp").write_text("this is not C++\n")
    with pytest.warns(UserWarning, match="native build of broken failed"):
        assert build_library("broken", ["broken.cpp"], source_dir=tmp_path, build_dir=tmp_path) is None
    assert not list(tmp_path.glob("*.so"))


@needs_gxx
@pytest.mark.parametrize("env_id", IDS)
def test_native_and_numpy_paths_step_alike(env_id):
    env = gym.make_vec(env_id, 256, vectorization_mode="vector_entry_point")
    native = env.stepper
    assert native.is_native
    plain = TabularBatchStepper(env.model)
    plain.lib = None
    assert not plain.is_native
    rng = np.random.default_rng(0)
    states = rng.integers(0, native.S, 256).astype(np.int32)
    for k in range(20):
        actions = rng.integers(0, native.A, 256)
        uniforms = rng.random(256)
        s_native, s_plain = states.copy(), states.copy()
        r_native, t_native = native.step(s_native, actions, uniforms)
        r_plain, t_plain = plain.step(s_plain, actions, uniforms)
        np.testing.assert_array_equal(s_native, s_plain, err_msg=f"step {k} states")
        np.testing.assert_array_equal(r_native, r_plain, err_msg=f"step {k} rewards")
        np.testing.assert_array_equal(t_native.astype(bool), t_plain.astype(bool), err_msg=f"step {k} flags")
        states = s_native


@pytest.mark.parametrize("env_id", IDS)
def test_vector_entry_point_equals_jax(env_id):
    port = gym.make_vec(env_id, 64, vectorization_mode="vector_entry_point")
    ref = jgym.make_vec(env_id, 64, vectorization_mode="vector_entry_point")
    assert isinstance(port, NativeTabularVectorEnv) and type(ref).__name__ == "NativeTabularVectorEnv"
    assert port.max_episode_steps == ref.max_episode_steps
    assert port.stepper.is_native == ref.stepper.is_native
    assert_identical(port.reset(seed=0), ref.reset(seed=0), "reset")
    rng = np.random.default_rng(1)
    ended = 0
    for k in range(500):
        actions = rng.integers(0, port.single_action_space.n, 64)
        want = ref.step(actions)
        assert_identical(port.step(actions), want, f"step {k}")
        ended += int((want[2] | want[3]).sum())
    assert ended > 0
    assert port.np_random.bit_generator.state == ref.np_random.bit_generator.state
