"""``make_dynamics``'s ``step``, ``bias``, ``kinetic_energy`` and ``potential``
of the port against the JAX package's (``step_fn``:
``tests/test_torch_mujoco_step_fn.py``; each file compiles JAX's functions
for three robots, about 12 s).

The same perturbed numpy states (every other lane lowered into the ground,
so contacts act) go to both sides; JAX runs its functions vmapped and jitted
on the CPU, the port on ``(N, ...)`` CPU tensors. Tolerance: ``1e-5 * max |JAX| + 1e-6`` an
output, that of the articulated tests (``tests/test_torch_mujoco_kinematics.py``).
"""

import jax
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu.physics import articulated as jart
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.physics import articulated as art
from tests.test_torch_mujoco_kinematics import assert_close, states

N = 16
# robot: (qpos index of the root's height, how far every other lane is lowered)
ROBOTS = {"half_cheetah": (1, 0.3), "ant": (2, 0.3), "hopper": (1, 0.1)}


def _inputs(name):
    model, _ = load_model(name)
    q, qd = states(model, N, seed=3, lower=ROBOTS[name])
    ctrl = np.random.default_rng(4).uniform(-1.0, 1.0, (N, model.nu)).astype(np.float32)
    return model, q, qd, ctrl


@pytest.mark.parametrize("name", sorted(ROBOTS))
def test_dynamics_match_jax(name):
    model, q, qd, ctrl = _inputs(name)
    dyn = jart.make_dynamics(jax_load_model(name)[0])

    def outputs(a, b, c):
        return (dyn["bias"](a, b), dyn["kinetic_energy"](a, b), dyn["potential"](a), *dyn["step"](a, b, c))

    want = jax.jit(jax.vmap(outputs))(q, qd, ctrl)
    port = art.make_dynamics(model)
    tq, tqd, tctrl = (torch.from_numpy(x) for x in (q, qd, ctrl))
    got = (port["bias"](tq, tqd), port["kinetic_energy"](tq, tqd), port["potential"](tq), *port["step"](tq, tqd, tctrl))
    for label, g, w in zip(("bias", "kinetic_energy", "potential", "step_q", "step_qd"), got, want):
        assert g.shape == np.shape(w), label
        assert_close(g.numpy(), np.asarray(w), label)
    # the contacts act, so the step's contact forces are compared too
    depth = np.asarray(model.contact_radius) - port["contact_points"](tq)[..., 2].numpy()
    assert (depth > 0).any(axis=1).mean() >= 0.25


def test_energies_of_a_lift_are_closed_form():
    """Moving Hopper along its root's z slide alone: the kinetic energy is
    that of its whole mass (with the slide's armature) at that speed, and
    lifting it by ``dz`` adds ``-g M dz`` of potential energy."""
    model, _ = load_model("hopper")
    dyn = art.make_dynamics(model)
    q = torch.tensor(art.init_qpos(model)[None], dtype=torch.float32)
    v = torch.zeros((1, model.nv))
    v[:, 1] = 2.0
    mass = float(np.sum(model.bodies.mass))
    want_t = 0.5 * (mass + float(model.joints.armature[1])) * 4.0
    assert float(dyn["kinetic_energy"](q, v)) == pytest.approx(want_t, rel=1e-5)
    lifted = q.clone()
    lifted[:, 1] += 0.5
    dv = float(dyn["potential"](lifted) - dyn["potential"](q))
    assert dv == pytest.approx(-model.gravity * mass * 0.5, rel=1e-5)
