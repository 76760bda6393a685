"""BipedalWalker's reset and ``walker_step`` of the port against the JAX package.

An eager ``jnp`` walker step takes 25-35 s on the CPU and a jit of it
minutes, so these comparisons use the JAX module's own numpy path,
``walker_step(np, ...)``, whose tables are float64: its float64 arithmetic
is inside each stated tolerance. The cases:

- the reset: the pre-settle state against JAX's pieces (draws recomputed
  from the key splits of JAX's ``initial``), the settle tick against
  ``walker_step(np, zeros)``, normal and hardcore;
- ``walker_step`` over 8 steps, each from the reference's own state
  (teacher-forced, so chaos does not compound), and a short free run;
- crash and finish lanes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.box2d import bipedal_walker as BW
from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as walker
from gymnasium_tpu_torch.ops import planar_step
from tests.test_torch_bipedal_walker import N, TERRAIN_TOL

# The JAX kernel test's tolerances (tests/ops/test_pallas_planar.py:107-110).
ENGINE_TOL = {"rtol": 0.0, "atol": 2e-4}
IMPULSE_TOL = {"rtol": 0.0, "atol": 1e-4}
# One env step (four solver ticks) in float32 against the numpy path's
# float64: largest seen 9.2e-6 in a body, 2.2e-6 in an impulse, 1.3e-5 in a
# shaping potential (about 14) and a reward, their difference.
STEP_TOL = {"bodies": ENGINE_TOL, "cimp": IMPULSE_TOL, "prev_shaping": IMPULSE_TOL, "r": IMPULSE_TOL}
# Four free-running steps, where the float32 and float64 trajectories part
# step by step: 3.7e-5 seen; held to the engine tolerance throughout.
FREE_TOL = ENGINE_TOL


def to_numpy(state):
    return {k: v.numpy() for k, v in state.items()}


def to_f64(state):
    return {k: v.astype(np.float64) if v.dtype != np.bool_ else v for k, v in to_numpy(state).items()}


def check_state(request, got, want, tol=STEP_TOL, label=""):
    """Hold the float leaves to ``tol`` (recording the deviations), ``done`` exactly."""
    for key, t in tol.items():
        g, w = np.asarray(got[key]), np.asarray(want[key])
        request.node.user_properties.append((f"max_abs_d{key}{label}", float(np.abs(g - w).max())))
        np.testing.assert_allclose(g, w, **t, err_msg=f"{key}{label}")
    np.testing.assert_array_equal(np.asarray(got["done"]), np.asarray(want["done"]), err_msg=f"done{label}")


def jax_reset_draws(n, hardcore, seed=0):
    """The draws of JAX's ``initial`` from ``n`` keys, recomputed outside
    ``jit`` from its key splits: the raw U[0, 1) draws for the port, the
    JAX-mapped ones for the reference."""
    keys = jax.random.split(jax.random.PRNGKey(seed), n)
    splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)
    k_t, k_o, k_k = splits[:, 0], splits[:, 1], splits[:, 2]
    raw = (
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (200,)))(k_t)),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (200,)))(k_o)),
        np.asarray(jax.vmap(lambda k: jax.random.uniform(k, ()))(k_k)),
    )
    mapped_u = jax.vmap(lambda k: jax.random.uniform(k, (200,), minval=-1.0, maxval=1.0))(k_t)
    kick = jax.vmap(lambda k: jax.random.uniform(k, (), minval=-BW.INITIAL_RANDOM, maxval=BW.INITIAL_RANDOM))(k_k)
    terrain = jax.vmap(lambda u, d: BW.generate_terrain(jnp, u, hardcore, d))(mapped_u, jnp.asarray(raw[1]))
    bodies = jnp.broadcast_to(jnp.asarray(BW.initial_bodies(np)), (n, 5, 6))
    bodies = bodies.at[:, 0, 3].add(kick / BW._HULL_MASS / BW.FPS)
    return raw, {"bodies": np.asarray(bodies), "terrain": np.asarray(terrain)}


@pytest.mark.parametrize("hardcore", [False, True])
def test_reset_matches_jax_pieces_and_settle_tick(request, hardcore):
    raw, ref_pre = jax_reset_draws(N, hardcore)
    env = BipedalWalkerFunctional({"hardcore": hardcore})
    draws = [torch.from_numpy(x) for x in raw]
    pre = env.reset_pre(*draws)
    # the pose, and the kick within an ulp: XLA on the CPU rounds a division
    # by a constant as a product with its reciprocal
    np.testing.assert_allclose(pre["bodies"].numpy(), ref_pre["bodies"], rtol=1.2e-7, atol=0.0)
    np.testing.assert_allclose(pre["terrain"].numpy(), ref_pre["terrain"], **TERRAIN_TOL)

    state = env.reset_values(*draws)
    ref, _ = BW.walker_step(np, {**to_f64(pre), "done": np.zeros(N, bool)}, np.zeros((N, 4)))
    ref["r"], ref["done"] = np.zeros(N), np.zeros(N, bool)
    check_state(request, to_numpy(state), ref)
    assert state["bodies"].dtype == torch.float32 and state["done"].dtype == torch.bool
    assert not torch.equal(state["bodies"], pre["bodies"])  # the settle tick moved the walker


@pytest.fixture(scope="module")
def reset_state():
    rng = np.random.default_rng(7)
    draws = [torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)) for shape in ((N, 200), (N, 200), (N,))]
    return BipedalWalkerFunctional().reset_values(*draws)


def test_walker_step_teacher_forced_matches_numpy_reference(request, reset_state):
    """8 steps of random actions, each step taken by both from the
    reference's own state."""
    rng = np.random.default_rng(8)
    ref = to_f64(reset_state)
    for k in range(8):
        action = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
        port = walker.walker_step({key: torch.from_numpy(np.asarray(v, np.float32) if v.dtype != np.bool_ else v)
                                   for key, v in ref.items()}, torch.from_numpy(action))
        ref, _ = BW.walker_step(np, ref, action.astype(np.float64))
        check_state(request, to_numpy(port), ref, label=f"[{k}]")


def test_walker_step_free_run(request, reset_state):
    """Four steps, each side from its own state, and no kernel launched on
    the CPU."""
    rng = np.random.default_rng(9)
    port, ref = reset_state, to_f64(reset_state)
    before = dict(planar_step.launches)
    for k in range(4):
        action = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
        port = walker.walker_step(port, torch.from_numpy(action))
        ref, _ = BW.walker_step(np, ref, action.astype(np.float64))
        check_state(request, to_numpy(port), ref, {key: FREE_TOL for key in STEP_TOL}, label=f"[{k}]")
    assert planar_step.launches == before


def test_walker_step_crash_and_finish_match_numpy_reference(request, reset_state):
    """A walker moved behind the start crashes (reward -100), one moved past
    the finish ends its episode with its shaping reward (about 384, held to
    a relative 1e-6), and one sunk 1.5 m into the ground is lifted by the
    position pass: all as the reference has them."""
    state = to_numpy(reset_state)
    bodies = state["bodies"].copy()
    lanes = np.arange(N) % 4
    bodies[lanes == 1, :, 1] -= 1.5
    bodies[lanes == 2, :, 0] -= 8.0
    bodies[lanes == 3, :, 0] += (walker.TERRAIN_LENGTH - walker.TERRAIN_GRASS) * walker.TERRAIN_STEP
    state["bodies"] = bodies
    action = np.random.default_rng(10).uniform(-1, 1, (N, 4)).astype(np.float32)
    port = walker.walker_step({k: torch.from_numpy(v) for k, v in state.items()}, torch.from_numpy(action))
    ref, _ = BW.walker_step(np, {k: v.astype(np.float64) if v.dtype != np.bool_ else v for k, v in state.items()},
                            action.astype(np.float64))
    check_state(request, to_numpy(port), ref, {"bodies": ENGINE_TOL, "r": {"rtol": 1e-6, "atol": 1e-4}})
    done = port["done"].numpy()
    assert done[lanes >= 2].all() and not done[lanes == 0].any()
    assert (port["r"].numpy()[lanes == 2] == -100.0).all()
    assert (port["r"].numpy()[lanes == 3] > 300.0).all()
