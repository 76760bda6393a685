"""BipedalWalker of the port against the JAX package's ``bipedal_walker.py``.

The JAX walker is never jitted here (its graph compiles for about a minute);
the JAX functions run eagerly or vmapped. The cases:

- the world tables, the spaces and the step limits, equal;
- ``generate_terrain``, normal and hardcore, on the same draws against
  JAX's ``lax.scan`` (vmapped): the terrain kernel's twin, and its source
  built with ``g++``, equal to the twin in every bit;
- ``ground_height_fn`` before the first knot, at the knots, between them and
  past the last; ``lidar_scan`` and ``observe_state`` on the same states;
- ``tests/test_torch_bipedal_walker_step.py`` holds the reset and
  ``walker_step``.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu.envs as jax_envs
import gymnasium_tpu_torch as torch_gym
from chip_smoke import walker_states
from gymnasium_tpu.envs.box2d import bipedal_walker as BW
from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional, BipedalWalkerHardcore
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as walker
from gymnasium_tpu_torch.error import Error
from gymnasium_tpu_torch.ops import walker_terrain
from gymnasium_tpu_torch.ops.build import SOURCE_DIR

N = 16
# XLA on the CPU turns the walk's division by SCALE into a multiply by the
# reciprocal and contracts it into a fused multiply-add; the port rounds each
# operation on its own, as the card does with -fmad=false. The few-ulp
# differences add up over the 200 points: 9.5e-7 seen on heights of 2-6 m.
TERRAIN_TOL = {"rtol": 0.0, "atol": 1e-5}


def test_world_tables_match_jax():
    port, ref = walker._WORLD, BW._WORLD
    for group in ("bodies", "joints", "contacts"):
        for field in getattr(ref, group)._fields:
            np.testing.assert_array_equal(
                getattr(getattr(port, group), field), getattr(getattr(ref, group), field), err_msg=f"{group}.{field}"
            )
    for field in ref._fields[3:]:
        assert getattr(port, field) == getattr(ref, field), field
    assert walker._SUBSTEPS == BW._SUBSTEPS
    for name in ("_HULL_MASS", "_HULL_COM", "_HULL_I", "_HIP_ANCHOR_HULL", "TERRAIN_STEP", "TERRAIN_HEIGHT"):
        assert getattr(walker, name) == getattr(BW, name), name


@pytest.mark.parametrize("hardcore", [False, True])
def test_spaces_and_step_limits_match_jax(hardcore):
    port = BipedalWalkerFunctional({"hardcore": hardcore})
    ref = BW.BipedalWalkerFunctional({"hardcore": hardcore})
    for a, b in ((port.observation_space, ref.observation_space), (port.action_space, ref.action_space)):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a.low, b.low)
        np.testing.assert_array_equal(a.high, b.high)
    env_id = "BipedalWalkerHardcore-v3" if hardcore else "BipedalWalker-v3"
    spec = jax_envs.registry[env_id]
    assert torch_gym.spec(env_id).max_episode_steps == spec.max_episode_steps == (2000 if hardcore else 1600)
    assert torch_gym.spec(env_id).kwargs == spec.kwargs
    assert port.hardcore == hardcore


def test_hardcore_class_is_a_construction_guard():
    with pytest.raises(Error, match="hardcore keyword"):
        BipedalWalkerHardcore()


@pytest.fixture(scope="module")
def terrain_draws():
    rng = np.random.default_rng(0)
    return rng.uniform(-1, 1, (64, 200)).astype(np.float32), rng.uniform(0, 1, (64, 200)).astype(np.float32)


@pytest.mark.parametrize("hardcore", [False, True])
def test_generate_terrain_matches_jax_scan(request, terrain_draws, hardcore):
    u, d = terrain_draws
    want = np.asarray(jax.vmap(lambda uu, dd: BW.generate_terrain(jnp, uu, hardcore, dd))(u, d))
    got = walker.generate_terrain(torch.from_numpy(u), torch.from_numpy(d) if hardcore else None).numpy()
    request.node.user_properties.append(("max_abs_dterrain", float(np.abs(got - want).max())))
    np.testing.assert_allclose(got, want, **TERRAIN_TOL)
    if hardcore:  # every window holds an obstacle, and each kind occurs
        plain = walker.generate_terrain(torch.from_numpy(u)).numpy()
        kinds = d[:, list(walker_terrain.WINDOWS)]
        assert (kinds < 0.33).any() and ((kinds >= 0.33) & (kinds < 0.66)).any() and (kinds >= 0.66).any()
        assert (got != plain).any(axis=1).all()


def test_terrain_kernel_source_built_on_host_equals_twin(tmp_path, terrain_draws):
    """``csrc/walker_terrain.cu`` compiled with ``g++`` (its host loop): no
    sine or cosine, so it equals the twin in every bit."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host g++")
    lib_path = tmp_path / "libwalker_terrain.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++", "-o", str(lib_path),
         str(SOURCE_DIR / "walker_terrain.cu")],
        check=True, capture_output=True,
    )
    host = ctypes.CDLL(str(lib_path)).walker_terrain_host
    host.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    u, d = (np.ascontiguousarray(x[:33]) for x in terrain_draws)
    for hardcore in (0, 1):
        out = np.empty_like(u)
        host(u.ctypes.data, d.ctypes.data, out.ctypes.data, u.shape[0], hardcore)
        twin = walker_terrain.walker_terrain_reference(torch.from_numpy(u), torch.from_numpy(d) if hardcore else None)
        assert out.tobytes() == twin.numpy().tobytes(), f"hardcore={hardcore}"


def test_terrain_on_cpu_runs_the_twin_and_checks_shapes(terrain_draws):
    u = torch.from_numpy(terrain_draws[0][:4])
    before = walker_terrain.launches
    assert torch.equal(walker_terrain.walker_terrain(u), walker_terrain.walker_terrain_reference(u))
    assert walker_terrain.launches == before
    with pytest.raises(ValueError):
        walker_terrain.walker_terrain(u[:, :199])
    with pytest.raises(ValueError):
        walker_terrain.walker_terrain(u, u[:3])


def test_ground_height_matches_jax(terrain_draws):
    """Before the first knot, at each knot, between knots and past the end."""
    terrain = walker.generate_terrain(torch.from_numpy(terrain_draws[0][:4])).numpy()
    knots = np.arange(200) * walker.TERRAIN_STEP
    x = np.concatenate([[-5.0, -1e-3, 0.0], knots, knots[:-1] + 0.3 * walker.TERRAIN_STEP,
                        [knots[-1], knots[-1] + 1e-3, knots[-1] + 7.0]]).astype(np.float32)
    x = np.broadcast_to(x, (4, x.size)).copy()
    got = walker.ground_height_fn(torch.from_numpy(terrain))(torch.from_numpy(x)).numpy()
    lookup = BW.ground_height_fn(jnp, jnp.asarray(terrain))  # over one (4,) column of x at a time
    want = np.asarray(jax.vmap(lookup, in_axes=1, out_axes=1)(jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, :3], terrain[:, :1].repeat(3, 1))
    np.testing.assert_array_equal(got[:, -3:], terrain[:, -1:].repeat(3, 1))


@pytest.fixture(scope="module")
def states():
    """Walker states: the settled reset of each lane, and the poses of
    ``chip_smoke.walker_states`` (assembled, sunk, in the air)."""
    inputs = walker_states(N, "cpu", seed=4)
    bodies, terrain = inputs[0], inputs[2]
    return {"bodies": bodies, "terrain": terrain}


def test_lidar_and_observation_match_jax(states):
    """The same float32 operations on the same states: equal, lidar and leg
    flags included."""
    got = walker.observe_state(states).numpy()
    want = np.asarray(BW.observe_state(jnp, {k: jnp.asarray(v.numpy()) for k, v in states.items()}))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.shape == (N, 24)
    lidar = got[:, 14:]
    assert ((lidar < 1.0).any() and (lidar == 1.0).any()), "no ray both hits and misses"
    assert got[:, 8].any() and not got[:, 8].all(), "no lane both on and off the ground"
