"""The centre-of-mass kernels of the port: their twins against the JAX
package, their emitted source, their wrapper, and the wrench sources they
must leave as they were.

``ops/articulated_codegen.py::com_velocity_program`` takes each body's
centre-of-mass velocity from the substep's forward kinematics and the
bodies' Jacobians; ``mass_center_x_program`` the whole robot's mass centre
along x. Over torch tensors they are the plain twins that
``ops/com_kinematics.py`` runs on a CPU tensor; emitted as C they are the
kernels, whose ``run`` is ``__host__ __device__``, so the same text built
with the host ``g++`` is held here against the twins before any card sees
it. The JAX package takes the velocities as a forward derivative
(``jax.jvp``) of ``com_world`` along ``integrate_pos``, and the mass centre
from ``com_world``: the same mathematics in another form, so the twins
equal it within ``tests/test_torch_mujoco_kinematics.py``'s tolerance
(largest seen: 2.6e-7 of max |JAX| in Humanoid's velocities). The build
calls glibc's ``sincosf``, whose bits differ from torch's CPU ``sin``/``cos``
by an ULP: so it equals the twin within a same-program tolerance, and in
every bit the twin run with glibc's ``sincosf`` (``_HostMathOps``). On the
card the kernels equal the plain twins in every bit
(``tests/test_torch_com_kinematics_gpu.py``).
"""

import ctypes
import hashlib
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu.physics import articulated as jart
from gymnasium_tpu_torch.envs.mujoco import HumanoidFunctional, HumanoidStandupFunctional
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops import com_kinematics as ck
from gymnasium_tpu_torch.ops.articulated_codegen import (
    com_velocity_program,
    generate_com_source,
    generate_wrench_source,
    mass_center_x_program,
    model_tables,
)
from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.physics import articulated as art
from tests.test_torch_contact_wrenches import _HostMathOps, gxx, host_sincos  # noqa: F401 (fixtures)
from tests.test_torch_mujoco_kinematics import ROBOTS, assert_close, states

N = 256
# the robots whose emitted source g++ builds: the two Humanoids the kernel
# serves, Ant (a free root, legs), Hopper (slides at the root, no free joint)
BUILT = ["ant", "hopper", "humanoid", "humanoidstandup"]
# the twin against the g++ build: only sin/cos ULPs differ (largest seen:
# 1.3e-7 of the largest |velocity|, 3.0e-8 of the largest |x|)
REL = 1e-5

# sha256 of each model's wrench source, named by the robot, as the parent
# of the com kernels emitted it: the shared generator must leave every byte
WRENCH_DIGESTS = {
    "ant": "7671fa18b8e272a981ebc5f7df0d2e85e11a382fdffadafd7418842ad5bb84ea",
    "humanoid": "918a8b983c8ba82796cfe712f8764b789fc9f9845e55fb9d8ba649cb6b6a7a00",
    "humanoidstandup": "da9ae878af31a11028871484981c17b2c74fa6ca39a0cc8fb5fe3eaeeb075783",
}


def _jax_com(model, q, qd):
    """JAX's com velocity (its ``jax.jvp``) and mass centre along x."""
    dyn = jart.make_dynamics(model)

    def one(q1, qd1):
        def com(t):
            return dyn["com_world"](jart.integrate_pos(model, q1, qd1, t))[0]

        _, vel = jax.jvp(com, (jnp.zeros(()),), (jnp.ones(()),))
        return dyn["com_world"](q1)[0], vel

    pc, vel = (np.asarray(x) for x in jax.jit(jax.vmap(one))(q, qd))
    mass = np.asarray(model.bodies.mass, np.float64)
    return vel, (mass * pc[..., 0]).sum(-1) / mass.sum()


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_twins_match_jax(robot):
    jmodel, _ = jax_load_model(robot)
    model, _ = load_model(robot)
    q, qd = states(jmodel, lower=ROBOTS[robot])
    want_vel, want_x = _jax_com(jmodel, q, qd)
    op = ck.com_kinematics_of(model)
    vel = op.velocity(torch.from_numpy(q), torch.from_numpy(qd)).numpy()
    x = op.mass_center_x(torch.from_numpy(q)).numpy()
    assert vel.shape == (len(q), len(model.bodies.parent), 3) and x.shape == (len(q),)
    assert_close(vel, want_vel, f"{robot} com_velocity")
    assert_close(x, want_x, f"{robot} mass_center_x")
    assert np.abs(want_vel).max() > 0.5  # moving states: the comparison is not of zeros


def _host_com(tmp_path, gxx, robot):  # noqa: F811 (a fixture's value)
    """The emitted source built with the host ``g++``: ``(q, qd) -> ((N,
    nbody, 3), (N,))``."""
    model, _ = load_model(robot)
    src, lib = tmp_path / f"{robot}_com.cpp", tmp_path / f"lib{robot}_com.so"
    src.write_text(generate_com_source(model, robot).text)
    subprocess.run([gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(SOURCE_DIR),
                    "-x", "c++", "-o", str(lib), str(src)], check=True, capture_output=True)
    built = ctypes.CDLL(str(lib))
    velocity, center = built.com_velocity_host, built.mass_center_x_host
    velocity.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    center.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int]
    nbody = len(model.bodies.parent)

    def run(q, qd):
        v, x = np.empty((len(q), nbody, 3), np.float32), np.empty(len(q), np.float32)
        velocity(q.ctypes.data, qd.ctypes.data, v.ctypes.data, len(q))
        center(q.ctypes.data, x.ctypes.data, len(q))
        return v, x

    return run


@pytest.mark.parametrize("robot", BUILT)
def test_emitted_source_matches_twin_on_host(request, tmp_path, gxx, host_sincos, robot):  # noqa: F811
    model, _ = load_model(robot)
    q, qd = states(model, n=N)
    got_v, got_x = _host_com(tmp_path, gxx, robot)(q, qd)
    op = ck.com_kinematics_of(model)
    tq, tqd = torch.from_numpy(q), torch.from_numpy(qd)
    for label, got, twin in (("velocity", got_v, op.reference_velocity(tq, tqd).numpy()),
                             ("mass_center_x", got_x, op.reference_mass_center_x(tq).numpy())):
        scale, err = float(np.abs(twin).max()), float(np.abs(got - twin).max())
        request.node.user_properties.append((f"max_abs_d{label}_over_max", err / scale))
        assert err <= REL * scale, f"{robot} {label}: max |host - twin| {err:.3e}, max |twin| {scale:.3e}"
    ops = _HostMathOps(host_sincos)
    rows = com_velocity_program(model_tables(model), ops, list(tq.T.contiguous()), list(tqd.T.contiguous()))
    glibc_v = torch.stack([torch.as_tensor(r, dtype=torch.float32).expand(N) for r in rows], 1).numpy()
    glibc_x = mass_center_x_program(model_tables(model), ops, list(tq.T.contiguous())).numpy()
    np.testing.assert_array_equal(got_v.reshape(N, -1).view(np.int32), glibc_v.view(np.int32))
    np.testing.assert_array_equal(got_x.view(np.int32), glibc_x.view(np.int32))


def test_cpu_path_runs_the_twins_and_launches_nothing():
    model, _ = load_model("humanoid")
    op = ck.com_kinematics_of(model)
    q, qd = (torch.from_numpy(x) for x in states(model, n=33))
    before = dict(ck.launches)
    vel, x = op.velocity(q, qd), op.mass_center_x(q)
    assert dict(ck.launches) == before and op._launch is None and op._source is None
    assert torch.equal(vel, op.reference_velocity(q, qd)) and torch.equal(x, op.reference_mass_center_x(q))
    assert vel.shape == (33, 13, 3) and x.shape == (33,) and vel.dtype == x.dtype == torch.float32
    # one object serves every load of the model, and both Humanoid envs call it
    assert ck.com_kinematics_of(load_model("humanoid")[0]) is op
    func = HumanoidFunctional()
    assert func._com is op and torch.equal(func.com_velocity(q, qd), vel) and torch.equal(func._com_x(q), x)
    obs = func.observation({"qpos": q, "qvel": qd, "prev_x": q[:, 0]}, None)
    assert torch.equal(obs[:, 175:253].reshape(33, 13, 6)[..., :3], vel)  # the cvel block: [velocity, 0] a body
    assert dict(ck.launches) == before
    assert HumanoidStandupFunctional()._com is ck.com_kinematics_of(load_model("humanoidstandup")[0])


def test_the_host_env_takes_its_velocities_from_the_twin():
    from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidEnv

    env = HumanoidEnv(device="cpu")
    env.reset(seed=3)
    q, qd = env._device_state()
    want = env._com.reference_velocity(q, qd)[0].numpy()
    np.testing.assert_array_equal(env._helper("com_velocity"), want)


@pytest.mark.parametrize("bad", ["q_width", "qd_batch", "one_dim", "float64", "qd_float64", "empty"])
def test_com_kinematics_reject_bad_inputs(bad):
    model, _ = load_model("humanoid")
    op = ck.com_kinematics_of(model)
    q, qd = (torch.from_numpy(x) for x in states(model, n=8))
    if bad == "q_width":
        q = q[:, :-1]
    elif bad == "qd_batch":
        qd = qd[:-1]
    elif bad == "one_dim":
        q = q[0]
    elif bad == "float64":
        q = q.double()
    elif bad == "qd_float64":
        qd = qd.double()
    else:
        q, qd = q[:0], qd[:0]
    with pytest.raises(ValueError):
        op.velocity(q, qd)
    if bad not in ("qd_batch", "qd_float64"):
        with pytest.raises(ValueError):
            op.mass_center_x(q)


def test_generated_source_is_stable_and_counted():
    model, _ = load_model("humanoid")
    a, b = generate_com_source(model, "humanoid"), generate_com_source(model, "humanoid")
    assert a.text == b.text
    lines = [line.strip() for line in a.text.splitlines()]
    split = lines.index("struct MassCenterX {")
    for part, counts in ((lines[:split], a.layout["com_velocity_ops"]), (lines[split:], a.layout["mass_center_x_ops"])):
        statements = sum(line.startswith(("const float t", "const bool t")) for line in part)
        pairs = sum("sincosf(" in line for line in part)
        assert statements + 2 * pairs == sum(counts.values())
        # the free root's rotations take no angle: one sincosf a hinge of the 17 joints
        hinges = sum(int(j) == art.HINGE for j in model.joints.jtype[6:])
        assert counts["sin"] == counts["cos"] == pairs == hinges == 17
    assert a.ops_per_env == sum(a.substep_ops.values()) == (
        sum(a.layout["com_velocity_ops"].values()) + sum(a.layout["mass_center_x_ops"].values()))
    assert sum(line.startswith("v[") for line in lines) == 3 * len(model.bodies.parent) == 39
    assert sum(line.startswith("return t") for line in lines) == 1
    # the profiler's roofline of the articulated build counts kernels whose names hold ArticulatedStep
    assert "ArticulatedStep" not in a.text
    for header in ("com_kinematics.cuh", "staged_rows.cuh"):
        assert "ArticulatedStep" not in (SOURCE_DIR / header).read_text()
    assert "struct ComVelocity {" in a.text and "COM_ENTRY_POINTS(ComVelocity, MassCenterX)" in a.text
    assert a.layout["row_floats"] == a.layout["row_stride"] == 39 and a.layout["row_stride"] % 2 == 1
    assert a.layout["threads_a_block"] * a.layout["row_stride"] * 4 <= 48 * 1024
    assert ck.com_kinematics_of(model).build_name.startswith("com_")


@pytest.mark.parametrize("robot", sorted(WRENCH_DIGESTS))
def test_wrench_sources_are_byte_for_byte_unchanged(robot):
    model, _ = load_model(robot)
    text = generate_wrench_source(model, robot).text
    assert hashlib.sha256(text.encode()).hexdigest() == WRENCH_DIGESTS[robot]


def test_a_build_is_named_by_every_header_it_reaches(monkeypatch, tmp_path):
    """Both generated sources reach ``staged_rows.cuh`` through their own
    header: an edit to it renames (so rebuilds) both libraries."""
    model, _ = load_model("humanoid")
    texts = {"com": generate_com_source(model, "humanoid").text,
             "wrenches": generate_wrench_source(model, "humanoid").text}
    reached = {k: build._headers(t.encode(), set()) for k, t in texts.items()}
    assert reached == {"com": {b"com_kinematics.cuh", b"staged_rows.cuh"},
                       "wrenches": {b"contact_wrenches.cuh", b"staged_rows.cuh"}}
    before = {k: build._digest(t.encode()) for k, t in texts.items()}
    for header in ("com_kinematics.cuh", "contact_wrenches.cuh", "staged_rows.cuh"):
        (tmp_path / header).write_bytes((SOURCE_DIR / header).read_bytes())
    (tmp_path / "staged_rows.cuh").write_bytes((SOURCE_DIR / "staged_rows.cuh").read_bytes() + b"// edited\n")
    monkeypatch.setattr(build, "SOURCE_DIR", tmp_path)
    after = {k: build._digest(t.encode()) for k, t in texts.items()}
    assert all(after[k] != before[k] for k in texts)
