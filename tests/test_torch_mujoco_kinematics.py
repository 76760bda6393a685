"""The batched kinematics helpers of the port against the JAX package's.

``physics/articulated.py`` of the port computes, on ``(N, ...)`` tensors,
what the JAX package's ``fk``, ``fk_full``, ``integrate_pos`` and
``make_dynamics`` helpers compute for one env: forward kinematics, the
bodies' centres of mass, the contact wrenches, the joint-limit torques, the
position update with the free root's quaternion, and (by a forward
derivative) the centres of mass's velocities. The same numpy states go to
both sides; JAX runs its helpers vmapped and jitted on the CPU.

Tolerance: both sides compute in float32 with the same formulas, in sums of
another order and with the CPU's own ``sin``/``cos``, so each output may
differ by ``1e-5 * max |JAX| + 1e-6`` (largest seen: 3.2e-7 of max |JAX|, in
Walker2d's contact wrenches). Every other lane is lowered into the ground,
and the test asserts that contacts act in at least a quarter of the lanes of
a robot that has contact spheres, so the wrench comparison is not empty.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu.physics import articulated as jart
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops.articulated_codegen import model_tables
from gymnasium_tpu_torch.physics import articulated as art

N = 32
REL, ABS = 1e-5, 1e-6
# robot: (qpos index of the root's height, how far every other lane is lowered)
ROBOTS = {
    "ant": (2, 0.3),
    "humanoid": (2, 0.9),
    "hopper": (1, 0.1),
    "walker2d_v5": (1, 0.1),
    "pusher_v5": (None, 0.0),
    "reacher": (None, 0.0),
    "inverted_double_pendulum": (None, 0.0),
}
OUTPUTS = ("fk_R", "fk_p", "full_R", "full_p", "full_axes", "full_pivots", "com", "com_R", "wrenches",
           "limit_torques", "integrate_pos", "com_velocity")


def states(model, n=N, seed=0, lower=(None, 0.0)):
    """Perturbed float32 states; every other lane lowered by ``lower``."""
    rng = np.random.default_rng(seed)
    q = np.tile(jart.init_qpos(model)[None, :], (n, 1)).astype(np.float32)
    q += rng.uniform(-0.3, 0.3, q.shape).astype(np.float32)
    if model.root_free:
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    index, depth = lower
    if index is not None:
        q[1::2, index] -= np.float32(depth)
    qd = rng.uniform(-1.0, 1.0, (n, model.nv)).astype(np.float32)
    return q, qd


def _jax_outputs(model, q, qd, dt):
    dyn = jart.make_dynamics(model)

    def one(q1, qd1):
        R, p = jart.fk(model, q1)
        fR, fp, axes, pivots = jart.fk_full(model, q1)
        pc, cR = dyn["com_world"](q1)

        def com(t):
            return dyn["com_world"](jart.integrate_pos(model, q1, qd1, t))[0]

        _, vel = jax.jvp(com, (jnp.zeros(()),), (jnp.ones(()),))
        return (R, p, fR, fp, axes, pivots, pc, cR, dyn["contact_wrenches"](q1, qd1),
                dyn["limit_torques"](q1, qd1), jart.integrate_pos(model, q1, qd1, dt), vel)

    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(q, qd)]


def _port_outputs(model, q, qd, dt):
    dyn = art.make_dynamics(model)

    def com(t):
        return dyn["com_world"](art.integrate_pos(model, q, qd, t))[0]

    zero = torch.zeros(())
    _, vel = torch.func.jvp(com, (zero,), (torch.ones(()),))
    out = (*art.fk(model, q), *art.fk_full(model, q), *dyn["com_world"](q), dyn["contact_wrenches"](q, qd),
           dyn["limit_torques"](q, qd), art.integrate_pos(model, q, qd, dt), vel)
    return [x.numpy() for x in out]


def assert_close(got, want, label):
    assert got.shape == want.shape, f"{label}: shape {got.shape}, want {want.shape}"
    err, scale = float(np.abs(got - want).max(initial=0.0)), float(np.abs(want).max(initial=0.0))
    assert err <= REL * scale + ABS, f"{label}: max |port - jax| {err:.3e}, max |jax| {scale:.3e}"


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_helpers_match_jax(robot):
    jmodel, _ = jax_load_model(robot)
    model, _ = load_model(robot)
    q, qd = states(jmodel, lower=ROBOTS[robot])
    dt = 2 * jmodel.timestep
    want = _jax_outputs(jmodel, q, qd, dt)
    got = _port_outputs(model, torch.from_numpy(q), torch.from_numpy(qd), dt)
    for label, g, w in zip(OUTPUTS, got, want):
        assert_close(g, w, f"{robot} {label}")
    assert got[8].shape == (N, len(model.bodies.parent), 6)
    if len(model.contact_body):
        touching = (np.abs(want[8]).reshape(N, -1).max(axis=1) > 0).mean()
        assert touching >= 0.25, f"contacts act in {touching:.0%} of the lanes"


def test_limit_torques_act_past_a_limit():
    """Hopper's joints pushed past their limits: the penalty acts on every
    limited dof and nowhere else, in both packages."""
    jmodel, _ = jax_load_model("hopper")
    model, _ = load_model("hopper")
    q, qd = states(jmodel, n=8)
    limited = np.asarray(jmodel.joints.limited)
    q[:, limited] = np.where(np.arange(8)[:, None] % 2, 1.1 * jmodel.joints.upper[limited] + 0.1,
                             1.1 * jmodel.joints.lower[limited] - 0.1).astype(np.float32)
    want = np.asarray(jax.vmap(jart.make_dynamics(jmodel)["limit_torques"])(q, qd))
    got = art.make_dynamics(model)["limit_torques"](torch.from_numpy(q), torch.from_numpy(qd)).numpy()
    assert_close(got, want, "limit_torques")
    assert (got[:, limited] != 0).all() and (got[:, ~limited] == 0).all()


def test_free_root_integration_keeps_a_unit_quaternion_and_takes_both_sides_of_the_exponential():
    model, _ = load_model("ant")
    q, qd = (torch.from_numpy(x) for x in states(model, n=8))
    qd[::2, 3:6] = 1e-7  # below the small-angle threshold of the exponential at this dt
    out = art.integrate_pos(model, q, qd, 0.01)
    assert torch.allclose(torch.linalg.vector_norm(out[:, 3:7], dim=1), torch.ones(8), atol=1e-6)
    jmodel, _ = jax_load_model("ant")
    want = np.asarray(jax.vmap(lambda a, b: jart.integrate_pos(jmodel, a, b, 0.01))(q.numpy(), qd.numpy()))
    assert_close(out.numpy(), want, "integrate_pos")


@pytest.mark.parametrize("robot", ["ant", "humanoidstandup", "hopper", "inverted_double_pendulum"])
def test_generator_folds_the_same_contact_and_limit_constants(robot):
    """The substep generator and the helpers read one fold of the contact
    and limit constants, which are those of the JAX ``make_dynamics``."""
    model, _ = load_model(robot)
    t = model_tables(model)
    limit_k, limit_c = art.limit_constants(model)
    contact_k, contact_c = art.contact_constants(model)
    assert t.limit_k == list(limit_k) and t.limit_c == list(limit_c)
    assert t.contact_k == list(contact_k) and t.contact_c == list(contact_c)
    jmodel, _ = jax_load_model(robot)
    m_eff = np.maximum(np.asarray(jmodel.bodies.mass)[np.asarray(jmodel.contact_body)], 1e-3).astype(np.float32)
    k_c = np.minimum(np.float32(jmodel.contact_stiffness), m_eff * np.float32((jmodel.contact_alpha / jmodel.timestep) ** 2))
    np.testing.assert_allclose(np.float32(contact_k), k_c, rtol=1e-6)
