"""The articulated substep of the port against the JAX package.

Three comparisons, on the perturbed states of
``tests/ops/test_pallas_articulated.py::_states``:

- the plain twin (the generator over torch tensors) against the JAX row
  program ``make_fused_step(m, fs).rows_step`` run eagerly under
  ``jax.disable_jit()`` on one 1024-env block. That is the Pallas kernel's
  own arithmetic, without the Pallas interpreter;
- the twin against ``make_dynamics(m)["step"]`` chained ``fs`` times, on the
  probe lanes of the JAX kernel test, with its tolerances;
- the generated kernel source compiled for the host with ``g++`` (the same
  text ``nvcc`` builds, whose ``run`` is ``__host__ __device__``) against the
  twin. It checks the generator's C before any card sees it.

Each case states its tolerance and records the largest deviation it saw.
Both sides differ only where ``sin``/``cos`` differ by an ULP; stiff contact
springs then amplify that.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco import mujoco_env as jax_mujoco_env
from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu.ops.pallas_articulated import BLOCK_ENVS
from gymnasium_tpu.ops.pallas_articulated import make_fused_step as jax_make_fused_step
from gymnasium_tpu.physics.articulated import init_qpos as jax_init_qpos
from gymnasium_tpu.physics.articulated import make_dynamics
from gymnasium_tpu_torch.envs.mujoco import mujoco_env
from gymnasium_tpu_torch.envs.mujoco.mujoco_env import MODEL_DIR, load_model
from gymnasium_tpu_torch.ops import articulated_step
from gymnasium_tpu_torch.ops.articulated_codegen import generate_source
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.physics.articulated import init_qpos

# tests/ops/test_pallas_articulated.py:110-117, the JAX kernel's own test
Q_TOL = {"rtol": 2e-4, "atol": 2e-3}
QD_TOL = {"rtol": 2e-3, "atol": 0.15}
# twin vs the JAX row program or the emitted C: the same operations in the
# same order, so only sin/cos ULPs differ (largest seen: 1.5e-7 in q, 6e-6 in qd)
SAME_PROGRAM_TOL = ({"rtol": 0.0, "atol": 1e-5}, {"rtol": 0.0, "atol": 1e-4})
PROBE = np.asarray([0, 7, 130, 1023])
# the compiled robot specs the JAX package ships, of which the port keeps a copy
JAX_MODEL_DIR = Path(jax_mujoco_env._MODEL_DIR)
MODELS = (
    "ant", "half_cheetah", "hopper", "humanoid", "humanoidstandup", "inverted_double_pendulum",
    "inverted_pendulum", "pusher", "pusher_v5", "reacher", "swimmer", "walker2d", "walker2d_v5",
)


def _states(model, n, seed=0):
    """tests/ops/test_pallas_articulated.py::_states, as numpy float32.

    For a free root, every eighth lane instead rests at ``init_qpos`` with no
    control and an angular velocity below 5e-4, so the quaternion
    exponential takes its small-angle side there (``chip_smoke.articulated_states``
    rests them at ``chip_smoke.rest_pose`` instead, which serves Humanoid too).
    """
    rng = np.random.default_rng(seed)
    q = np.tile(jax_init_qpos(model)[None, :], (n, 1)).astype(np.float32)
    q += rng.uniform(-0.2, 0.2, q.shape).astype(np.float32)
    if model.root_free:
        q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)
    qd = rng.uniform(-0.5, 0.5, (n, model.nv)).astype(np.float32)
    ctrl = rng.uniform(-0.4, 0.4, (n, max(model.nu, 1))).astype(np.float32)
    if model.root_free:
        q[::8] = jax_init_qpos(model)
        qd[::8] = 0.0
        qd[::8, 3:6] = rng.uniform(-5e-4, 5e-4, qd[::8, 3:6].shape)
        ctrl[::8] = 0.0
    return q, qd, ctrl[:, : model.nu]


def _small_angle_lanes(model, qd_out):
    """Lanes whose last substep took the small-angle side (th2 <= 1e-10) of
    the free root's quaternion exponential: it turns by ``dt * qd'[3:6]``."""
    th2 = ((model.timestep * qd_out[:, 3:6].astype(np.float64)) ** 2).sum(axis=1)
    return int((th2 <= 1e-10).sum())


def _twin(robot, frame_skip, q, qd, ctrl):
    model, _ = load_model(robot)
    step = articulated_step.make_fused_step(model, frame_skip, robot)
    tq, tqd = step(torch.from_numpy(q), torch.from_numpy(qd), torch.from_numpy(ctrl))
    return tq.numpy(), tqd.numpy()


def _check(request, got, want, q_tol, qd_tol):
    """Record the largest deviations on the test (reports list them), then assert."""
    (tq, tqd), (jq, jqd) = got, want
    request.node.user_properties.append(("max_abs_dq", float(np.abs(tq - jq).max())))
    request.node.user_properties.append(("max_abs_dqd", float(np.abs(tqd - jqd).max())))
    np.testing.assert_allclose(tq, jq, **q_tol, err_msg="qpos diverges")
    np.testing.assert_allclose(tqd, jqd, **qd_tol, err_msg="qvel diverges")


@pytest.mark.parametrize("robot, frame_skip", [("reacher", 2), ("half_cheetah", 5), ("ant", 1)])
def test_twin_matches_jax_row_program(request, robot, frame_skip):
    jmodel, _ = jax_load_model(robot)
    n, nq, nv, nu = BLOCK_ENVS, jmodel.nq, jmodel.nv, jmodel.nu
    q, qd, ctrl = _states(jmodel, n, seed=1)

    def to_block(x, rows):  # test_pallas_articulated.py:31-37, one block
        return jnp.asarray(x.reshape(8, 128, rows).transpose(2, 0, 1).reshape(rows * 8, 128))

    def from_block(x, rows):
        return np.asarray(x).reshape(rows, 8, 128).transpose(1, 2, 0).reshape(n, rows)

    rows_step = jax_make_fused_step(jmodel, frame_skip).rows_step
    with jax.disable_jit():
        jq, jqd = rows_step(to_block(q, nq), to_block(qd, nv), to_block(ctrl, nu))
    want = from_block(jq, nq), from_block(jqd, nv)
    _check(request, _twin(robot, frame_skip, q, qd, ctrl), want, *SAME_PROGRAM_TOL)
    if jmodel.root_free:
        assert _small_angle_lanes(jmodel, want[1]) >= n // 8


@pytest.mark.parametrize(
    "robot, frame_skip", [("reacher", 2), ("hopper", 4), ("half_cheetah", 5), ("ant", 5)]
)
def test_twin_matches_make_dynamics(request, robot, frame_skip):
    jmodel, _ = jax_load_model(robot)
    dyn = make_dynamics(jmodel)
    q, qd, ctrl = _states(jmodel, BLOCK_ENVS, seed=1)

    def chained(q1, qd1, c1):
        return jax.lax.fori_loop(0, frame_skip, lambda _, s: dyn["step"](*s, c1), (q1, qd1))

    jq, jqd = jax.jit(jax.vmap(chained))(q[PROBE], qd[PROBE], ctrl[PROBE])
    tq, tqd = _twin(robot, frame_skip, q, qd, ctrl)
    _check(request, (tq[PROBE], tqd[PROBE]), (np.asarray(jq), np.asarray(jqd)), Q_TOL, QD_TOL)


def _host_step(tmp_path, robot, frame_skip, parts=None):
    """The generated source (the robot's own layout, or ``parts`` warps)
    built with the host ``g++``: ``step(q, qd, ctrl) -> (q', qd')``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host g++")
    model, _ = load_model(robot)
    src = tmp_path / f"{robot}_{parts}.cpp"
    src.write_text(generate_source(model, frame_skip, robot, parts=parts).text)
    lib_path = tmp_path / f"lib{robot}_{parts}.so"
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-shared", "-fPIC", "-I", str(SOURCE_DIR),
         "-x", "c++", "-o", str(lib_path), str(src)],
        check=True, capture_output=True,
    )
    host_step = ctypes.CDLL(str(lib_path)).articulated_step_host
    host_step.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int]

    def step(q, qd, ctrl):
        cq, cqd = np.empty_like(q), np.empty_like(qd)
        host_step(q.ctypes.data, qd.ctypes.data, ctrl.ctypes.data, cq.ctypes.data, cqd.ctypes.data, len(q))
        return cq, cqd

    return step


@pytest.mark.parametrize("robot, frame_skip", [("reacher", 2), ("half_cheetah", 5), ("ant", 1)])
def test_emitted_source_matches_twin_on_host(request, tmp_path, robot, frame_skip):
    """The robot's own layout (``articulated_codegen.choose_layout``):
    warp-specialised for half_cheetah and ant, run on the host one partition
    after another, phase by phase."""
    model, _ = load_model(robot)
    q, qd, ctrl = _states(model, 512, seed=2)
    cq, cqd = _host_step(tmp_path, robot, frame_skip)(q, qd, ctrl)
    _check(request, _twin(robot, frame_skip, q, qd, ctrl), (cq, cqd), *SAME_PROGRAM_TOL)
    if model.root_free:
        assert _small_angle_lanes(model, cqd) >= len(q) // 8


@pytest.mark.parametrize(
    "robot, frame_skip, parts",
    [("half_cheetah", 5, 2), ("half_cheetah", 5, 8), ("ant", 1, 2), ("ant", 1, 4), ("hopper", 4, 2),
     ("reacher", 2, 2)],
)
def test_partitioned_source_gives_the_one_thread_bits_on_host(tmp_path, robot, frame_skip, parts):
    """The partitioned text and the one-thread text, both built with ``g++``,
    give the same bits on every lane. (Both stand within the same-program
    tolerance of the twin, not at its bits: the host's ``sinf``/``cosf``
    differ from torch's CPU kernels by an ULP. On the card the kernel equals
    the twin in every bit: ``chip_smoke.compare_articulated_with_twin``.)"""
    model, _ = load_model(robot)
    q, qd, ctrl = _states(model, 256, seed=5)
    got = _host_step(tmp_path, robot, frame_skip, parts)(q, qd, ctrl)
    want = _host_step(tmp_path, robot, frame_skip, 1)(q, qd, ctrl)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_generated_source_is_stable_and_counted():
    model, _ = load_model("half_cheetah")
    a = generate_source(model, 5, "half_cheetah", parts=1)
    b = generate_source(model, 5, "half_cheetah", parts=1)
    assert a.text == b.text
    # one statement a counted operation, each substep looped, not unrolled
    statements = sum(line.strip().startswith("const float t") or line.strip().startswith("const bool t")
                     for line in a.text.splitlines())
    assert statements == sum(a.prologue_ops.values()) + sum(a.substep_ops.values())
    assert a.ops_per_env == sum(a.prologue_ops.values()) + 5 * sum(a.substep_ops.values())
    assert "ART_NO_UNROLL" in a.text and "for (int s = 0; s < 5; ++s)" in a.text
    assert a.substep_ops["cos"] == a.substep_ops["sin"] == 7  # one per hinge
    assert a.prologue_ops == {"max": 6, "min": 6, "mul": 6}  # clip and gear, once a call


def test_free_root_exponential_is_a_select():
    """Ant's quaternion exponential branches on th2 > 1e-10 as a select."""
    model, _ = load_model("ant")
    text = generate_source(model, 1, "ant").text
    assert "> 1.00000001e-10f;" in text
    assert "return" not in text.split("static ART_FN void run")[1].split("ART_ENTRY_POINTS")[0]


def test_cpu_step_runs_the_twin_and_launches_nothing():
    model, _ = load_model("hopper")
    step = articulated_step.make_fused_step(model, 2, "hopper")
    q, qd, ctrl = (torch.from_numpy(x) for x in _states(model, 33, seed=3))
    before = dict(articulated_step.launches)
    out = step(q, qd, ctrl)
    ref = step.reference(q, qd, ctrl)
    assert articulated_step.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].shape == (33, model.nq) and out[1].dtype == torch.float32


@pytest.mark.parametrize("bad", ["q_width", "ctrl_batch", "one_dim"])
def test_step_rejects_bad_shapes(bad):
    model, _ = load_model("hopper")
    step = articulated_step.make_fused_step(model, 1, "hopper")
    q, qd, ctrl = (torch.from_numpy(x) for x in _states(model, 8))
    if bad == "q_width":
        q = q[:, :-1]
    elif bad == "ctrl_batch":
        ctrl = ctrl[:-1]
    else:
        qd = qd[0]
    with pytest.raises(ValueError):
        step(q, qd, ctrl)


def test_models_load_in_place():
    model, meta = load_model("half_cheetah")
    assert (MODEL_DIR / "half_cheetah.npz").exists()
    assert (model.nq, model.nv, model.nu, len(model.contact_body)) == (9, 9, 6, 24)
    jmodel, _ = jax_load_model("half_cheetah")
    np.testing.assert_array_equal(init_qpos(model), jax_init_qpos(jmodel))
    # an .xml name compiles the MJCF file (tests/test_torch_mjcf.py); a missing one raises as JAX's does
    with pytest.raises(OSError):
        load_model("custom.xml")


def test_port_keeps_every_model_of_the_jax_package():
    assert sorted(p.stem for p in JAX_MODEL_DIR.glob("*.npz")) == list(MODELS)
    assert sorted(p.stem for p in MODEL_DIR.glob("*.npz")) == list(MODELS)


@pytest.mark.parametrize("name", MODELS)
def test_port_model_is_a_byte_copy(name):
    assert (MODEL_DIR / f"{name}.npz").read_bytes() == (JAX_MODEL_DIR / f"{name}.npz").read_bytes()


def test_load_model_reads_the_port_directory(monkeypatch, tmp_path):
    port_dir = Path(mujoco_env.__file__).resolve().parent / "models"
    assert MODEL_DIR == port_dir and "gymnasium_tpu_torch" in port_dir.parts
    # a model found only in MODEL_DIR loads, so load_model reads nothing else
    want = load_model("reacher")[0].nq
    (tmp_path / "only_here.npz").write_bytes((port_dir / "reacher.npz").read_bytes())
    monkeypatch.setattr(mujoco_env, "MODEL_DIR", tmp_path)
    try:
        assert load_model("only_here")[0].nq == want
    finally:
        mujoco_env._load_npz_model.cache_clear()
