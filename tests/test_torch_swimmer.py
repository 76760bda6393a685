"""Swimmer of the port against the JAX package's ``SwimmerFunctional``.

The JAX side runs vmapped and jitted on the CPU; the port steps the
articulated twin (``device="cpu"``), one call a substep at ``frame_skip=1``.

- ``mass_matrix`` (the JAX ``make_dynamics``'s) and the unrolled Cholesky
  solve (``_spd_solve``) on the same states, the fluid drag torques against
  the JAX step's own ``drag_torques`` (read from the jitted step's closure),
  the transition, observation and reward: within ``1e-5 * max |JAX| + 1e-6``
  (``tests/test_torch_mujoco_kinematics.py::assert_close``), the tolerance
  of the kinematics helpers. The transition is JAX's engine ``step`` on one
  side and the generated substep on the other, which
  ``tests/test_torch_mujoco.py`` holds together at the JAX kernel test's
  ``Q_TOL``/``QD_TOL``; on these states the closer tolerance holds.
- the reset: JAX's ``initial`` against the port's ``reset_values`` fed the
  uniforms and normals recomputed from the same key splits (1e-6);
- the step under ``torch.inference_mode()`` gives the same bits as without;
- ``TorchVectorEnv`` against ``JaxVectorEnv`` across autoresets, at the
  engine tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from gymnasium_tpu.envs.mujoco import swimmer as jax_swimmer
from gymnasium_tpu.physics import articulated as jart
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.mujoco import SwimmerFunctional
from gymnasium_tpu_torch.ops import articulated_step
from gymnasium_tpu_torch.physics import articulated as art
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.test_torch_mujoco import Q_TOL, QD_TOL
from tests.test_torch_mujoco_kinematics import assert_close, states
from tests.test_torch_mujoco_robots import _jax_initial
from tests.test_torch_mujoco_robots_vector import _injected, _reset_states

N = 16
VEC_N, VEC_STEPS, TIME_LIMIT = 8, 8, 3


def jax_step_closure():
    """The JAX step's ``drag_torques`` and ``make_dynamics`` helpers."""
    step, _ = jax_swimmer._swimmer_step(4)
    fn = step.__wrapped__
    cells = dict(zip(fn.__code__.co_freevars, fn.__closure__))
    return cells["drag_torques"].cell_contents, cells["dyn"].cell_contents


def as_torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def test_mass_matrix_and_solve_match_jax():
    model = SwimmerFunctional().model
    q, qd = states(model, N, seed=1)
    _, jdyn = jax_step_closure()
    want_m = np.asarray(jax.jit(jax.vmap(jdyn["mass_matrix"]))(q))
    got_m = art.make_dynamics(model)["mass_matrix"](*as_torch(q)).numpy()
    assert got_m.shape == (N, model.nv, model.nv)
    assert_close(got_m, want_m, "mass_matrix")
    np.testing.assert_allclose(got_m, np.swapaxes(got_m, 1, 2), rtol=0, atol=1e-6 * np.abs(got_m).max())
    b = np.random.default_rng(0).normal(size=(N, model.nv)).astype(np.float32)
    want_x = np.asarray(jax.jit(jax.vmap(lambda A, v: jart._spd_solve(jnp, A, v)))(want_m, b))
    got_x = art.spd_solve(*as_torch(want_m, b)).numpy()
    assert_close(got_x, want_x, "spd_solve")
    np.testing.assert_allclose(np.einsum("nij,nj->ni", want_m.astype(np.float64), got_x), b, atol=1e-4)


def test_jacobians_give_the_com_velocity_of_jax():
    """``Jv qd`` is the forward derivative of the centres of mass along ``qd``."""
    model = SwimmerFunctional().model
    q, qd = states(model, N, seed=4)
    _, jdyn = jax_step_closure()
    want = np.asarray(jax.jit(jax.vmap(lambda a, b: jax.jvp(lambda x: jdyn["com_world"](x)[0], (a,), (b,))[1]))(q, qd))
    _, _, Jv, Jw = art.make_dynamics(model)["jacobians"](*as_torch(q))
    got = torch.sum(Jv * torch.from_numpy(qd)[:, None, :, None], dim=2).numpy()
    assert_close(got, want, "Jv qd")
    assert Jw.shape == Jv.shape == (N, len(model.bodies.parent), model.nv, 3)


def test_drag_torques_match_jax():
    func = SwimmerFunctional()
    q, qd = states(func.model, N, seed=1)
    qd *= np.float32(3.0)  # the quadratic drag matters at speed
    jdrag, _ = jax_step_closure()
    want = np.asarray(jax.jit(jax.vmap(jdrag))(q, qd))
    got = func.drag_torques(*as_torch(q, qd)).numpy()
    assert_close(got, want, "drag torques")
    assert np.abs(want).max() > 10.0


def test_transition_observation_reward_match_jax():
    func, jfunc = SwimmerFunctional(), jax_swimmer.SwimmerFunctional()
    q, qd = states(func.model, N, seed=2)
    action = np.random.default_rng(3).uniform(-1, 1, (N, func.model.nu)).astype(np.float32)
    state = {"qpos": q, "qvel": qd, "prev_x": q[:, 0]}

    def hooks(s, a):
        ns = jfunc.transition(s, a, None)
        return ns, jfunc.observation(ns, None), jfunc.reward(s, a, ns, None), jfunc.terminal(ns, None)

    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(hooks))(state, action))
    tstate = dict(zip(state, as_torch(*state.values())))
    before = dict(articulated_step.launches)
    ns = func.transition(tstate, torch.from_numpy(action), None)
    got = (ns, func.observation(ns, None), func.reward(tstate, torch.from_numpy(action), ns, None),
           func.terminal(ns, None))
    assert articulated_step.launches == before, "the CPU batch launched a kernel"
    for key in ("qpos", "qvel", "prev_x"):
        assert_close(ns[key].numpy(), want[0][key], key)
    assert got[1].shape == (N, 8) == (N, *func.observation_space.shape)
    assert_close(got[1].numpy(), want[1], "observation")
    assert_close(got[2].numpy(), want[2], "reward")
    np.testing.assert_array_equal(got[3].numpy(), want[3])
    assert func.frame_skip == jfunc.frame_skip == 4 and func.dt == jfunc.dt
    assert func._step.frame_skip == 1 and func._step.name == "swimmer"


def test_transition_under_inference_mode_gives_the_same_bits():
    func = SwimmerFunctional()
    q, qd = states(func.model, N, seed=5)
    state = dict(zip(("qpos", "qvel", "prev_x"), as_torch(q, qd, q[:, 0])))
    action = torch.full((N, 2), 0.5)
    plain = func.transition(state, action, None)
    with torch.inference_mode():
        inferred = func.transition(state, action, None)
    with torch.no_grad():
        no_grad = func.transition(state, action, None)
    for key in plain:
        assert torch.equal(plain[key], inferred[key]) and torch.equal(plain[key], no_grad[key]), key


def test_reset_matches_jax_initial():
    func = SwimmerFunctional()
    want, drawn = _jax_initial("swimmer", jax_swimmer.SwimmerFunctional(), jax.random.split(jax.random.PRNGKey(7), 64))
    got = func.reset_values(*drawn)
    for key in ("qpos", "qvel", "prev_x"):
        np.testing.assert_allclose(got[key].numpy(), want[key], rtol=0, atol=1e-6, err_msg=key)


def test_vector_env_matches_jax_across_autoresets(request):
    resets = _reset_states("swimmer", SwimmerFunctional(), VEC_STEPS + 1)
    tenv = TorchVectorEnv(_injected(SwimmerFunctional, resets, torch.from_numpy), VEC_N,
                          max_episode_steps=TIME_LIMIT, device="cpu")
    jenv = JaxVectorEnv(_injected(jax_swimmer.SwimmerFunctional, resets, jnp.asarray, jit=True), num_envs=VEC_N,
                        max_episode_steps=TIME_LIMIT, jit=False)
    tobs, _ = tenv.reset(seed=0)
    jobs, _ = jenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **QD_TOL)
    acts = np.random.default_rng(1).uniform(-1, 1, (VEC_STEPS, VEC_N, 2)).astype(np.float32)
    worst, truncations = 0.0, 0
    for s in range(VEC_STEPS):
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(acts[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(acts[s]))
        state, jstate = tenv.carry.state, jenv.carry.state
        for key, got, want, tol in (("qpos", state["qpos"], jstate["qpos"], Q_TOL),
                                    ("qvel", state["qvel"], jstate["qvel"], QD_TOL),
                                    ("obs", to, jo, QD_TOL), ("reward", tr, jr, QD_TOL)):
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol, err_msg=f"step {s} {key}")
            worst = max(worst, float(np.abs(got.numpy() - np.asarray(want)).max()))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
        truncations += int(ttr.sum())
    request.node.user_properties.append(("max_abs_dev", worst))
    assert truncations > 0
