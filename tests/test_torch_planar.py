"""The planar (Box2D-class) solver step of the port against the JAX package.

The inputs are ``chip_smoke.planar_states``: the lander states of
``tests/ops/test_pallas_planar.py::_random_lander_states``, lanes with the
legs at the ground, the creation pose (the reset tick's input) and lanes deep
in the ground beyond both ends of the terrain, so every side of the solver is
reached (asserted). Three comparisons:

- the plain twin (the generator over torch tensors) against the JAX row
  program ``make_fused_planar_step(...).rows_step``, run eagerly under
  ``jnp``. That is the Pallas kernel's own arithmetic;
- the twin against JAX ``world_step`` chained over both substeps, at the
  JAX kernel test's tolerances (``test_pallas_planar.py:107-110``);
- the generated kernel source compiled for the host with ``g++`` (the same
  text ``nvcc`` builds, whose ``run`` is ``__host__ __device__``) against the
  twin, and against the same program emitted with its solver iterations
  unrolled (``tools/port_planar_probe.py::unrolled_step``), bit for bit.

Each case states its tolerance and records the largest deviation it saw.
Flags are compared exactly.
"""

import ctypes
import hashlib
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu.envs.dynamics.lunar_lander as L
from chip_smoke import planar_branch_lanes, planar_states
from gymnasium_tpu.ops.pallas_planar import make_fused_planar_step as jax_make_fused_planar_step
from gymnasium_tpu.physics.planar import world_step
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.ops import planar_step
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.ops.planar_codegen import generate_planar_source
from tools.port_planar_probe import unrolled_generator, unrolled_step

N = 512
WIDTHS = {"bodies": 18, "external": 9, "terrain": 11, "jimp": 10, "cimp": 20}
# tests/ops/test_pallas_planar.py:107-110, the JAX kernel's own test
ENGINE_TOL = {
    "bodies": {"rtol": 0.0, "atol": 2e-4},
    "jimp": {"rtol": 0.0, "atol": 1e-4},
    "cimp": {"rtol": 0.0, "atol": 1e-4},
}
# twin vs the JAX row program or the emitted C: the same operations in the
# same order, so only sin/cos ULPs differ. Largest seen: 9.5e-6 in bodies, 5
# ULPs of a hull at x = 21 m beyond the terrain's end (hence the rtol), 3e-6
# on the terrain, 6e-7 in the impulses.
SAME_PROGRAM = {"rtol": 1e-6, "atol": 1e-5}
SAME_PROGRAM_TOL = {"bodies": SAME_PROGRAM, "jimp": SAME_PROGRAM, "cimp": SAME_PROGRAM}


@pytest.fixture(scope="module")
def inputs():
    return tuple(x.numpy() for x in planar_states(N, "cpu", seed=1))


@pytest.fixture(scope="module")
def twin(inputs):
    out = dyn.lander_step(-10.0)(*(torch.from_numpy(x) for x in inputs))
    return tuple(x.numpy() for x in out)


def _check(request, got, want, tol):
    """Record the largest deviations on the test (reports list them), then assert."""
    for label, g, w in zip(("bodies", "jimp", "cimp"), got[:3], want[:3]):
        request.node.user_properties.append((f"max_abs_d{label}", float(np.abs(g - w).max())))
        np.testing.assert_allclose(g, w, **tol[label], err_msg=f"{label} diverges")
    np.testing.assert_array_equal(got[3], want[3], err_msg="contact flags differ")


def test_inputs_reach_every_side_of_the_solver(inputs):
    counts = planar_branch_lanes(dyn.lander_step(-10.0), *(torch.from_numpy(x) for x in inputs))
    assert all(count > 0 for count in counts.values()), counts


def test_twin_matches_jax_row_program(request, inputs, twin):
    world = L._lander_world(-10.0)
    rows_step = jax_make_fused_planar_step(
        world, L.CHUNKS, L.W / (L.CHUNKS - 1), L._MOTOR_SPEED, L._MOTOR_TORQUE, substeps=L._SUBSTEPS
    ).rows_step
    rows = [
        [jnp.asarray(col) for col in x.reshape(N, WIDTHS[label]).T]
        for label, x in zip(WIDTHS, inputs)
    ]
    body_r, jimp_r, cimp_r, flags = rows_step(*rows)

    def stack(groups, shape):
        return np.stack([np.asarray(r) for grp in groups for r in grp], axis=1).reshape(shape)

    want = (
        stack(body_r, (N, 3, 6)),
        stack(jimp_r, (N, 2, 5)),
        stack(cimp_r, (N, 10, 2)),
        np.stack([np.asarray(f) for f in flags], axis=1),
    )
    _check(request, twin, want, SAME_PROGRAM_TOL)


def test_twin_matches_chained_world_step(request, inputs, twin):
    """Both substeps of ``world_step``, warm starts and external forces
    included, as ``test_pallas_planar.py::test_fused_planar_matches_world_step``
    chains them."""
    bodies, ext, terrain, jimp, cimp = (jnp.asarray(x) for x in inputs)
    world = L._lander_world(-10.0)
    gh = lambda px: L.ground_height(jnp, terrain, px)  # noqa: E731
    warm, flags = (jimp, cimp), None
    for _ in range(L._SUBSTEPS):
        bodies, flags, warm = world_step(
            jnp, bodies, world, jnp.asarray(L._MOTOR_SPEED), jnp.asarray(L._MOTOR_TORQUE), gh,
            external_force=ext, warm_start=warm,
        )
    want = tuple(np.asarray(x) for x in (bodies, warm[0], warm[1], flags))
    _check(request, twin, want, ENGINE_TOL)


def _host_run(tmp_path, text, inputs):
    """Build an emitted source with the host ``g++`` and run it on ``inputs``.

    ``-fno-builtin`` keeps ``fminf``/``fmaxf`` library calls: as builtins g++
    may return either zero when both operands are zeros of opposite sign (C
    leaves it open), and picks differently in the rolled and unrolled forms.
    """
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs a host g++")
    digest = hashlib.sha256(text.encode()).hexdigest()[:12]
    src, lib_path = tmp_path / f"planar-{digest}.cpp", tmp_path / f"libplanar-{digest}.so"
    src.write_text(text)
    subprocess.run(
        [gxx, "-O1", "-ffp-contract=off", "-fno-builtin", "-shared", "-fPIC", "-I", str(SOURCE_DIR),
         "-x", "c++", "-o", str(lib_path), str(src)],
        check=True, capture_output=True,
    )
    host_step = ctypes.CDLL(str(lib_path)).planar_step_host
    host_step.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int]
    ins = [np.ascontiguousarray(x) for x in inputs]
    n = ins[0].shape[0]
    outs = [np.empty_like(ins[0]), np.empty_like(ins[3]), np.empty_like(ins[4]),
            np.empty((n, ins[4].shape[1]), np.bool_)]
    host_step(*(x.ctypes.data for x in ins + outs), n)
    return tuple(outs)


def test_emitted_source_matches_twin_on_host(request, tmp_path, inputs, twin):
    outs = _host_run(tmp_path, dyn.lander_step(-10.0).source.text, inputs)
    _check(request, twin, outs, SAME_PROGRAM_TOL)


def test_rolled_source_gives_the_unrolled_bits_on_host(tmp_path, inputs):
    """Both forms call the same host ``sinf``/``cosf`` (glibc's ``sincosf``
    gives their bits), so any differing bit is a fault of the loop emission."""
    step = dyn.lander_step(-10.0)
    rolled = _host_run(tmp_path, step.source.text, inputs)
    unrolled = _host_run(tmp_path, unrolled_step(step).source.text, inputs)
    for label, a, b in zip(("bodies", "jimp", "cimp", "flags"), rolled, unrolled):
        assert a.tobytes() == b.tobytes(), f"{label}: the rolled form's bits differ"


def test_generated_source_is_stable_and_counted():
    step = dyn.lander_step(-10.0)
    world = step.world
    args = (world, 11, dyn.W / 10, dyn._MOTOR_SPEED, dyn._MOTOR_TORQUE, 2, "x")
    a = generate_planar_source(*args)
    assert a.text == generate_planar_source(*args).text
    with unrolled_generator():
        unrolled = generate_planar_source(*args)
    lines = [line.strip() for line in a.text.splitlines()]
    assert "PLANAR_NO_UNROLL" in lines and "for (int sub = 0; sub < 2; ++sub) {" in lines
    # the velocity and position iterations are one loop each, not unrolled
    for iterations in (world.velocity_iterations, world.position_iterations):
        loop = f"for (int it = 0; it < {iterations}; ++it) {{"
        assert lines.count(loop) == 1 and lines[lines.index(loop) - 1] == "PLANAR_NO_UNROLL"
    # one sincosf an angle: 3 bodies before the velocity pass; in a position
    # iteration one a contact and two a joint
    sites = len(world.bodies.inv_mass) + len(world.contacts.body) + 2 * len(world.joints.body_a)
    assert sum(line.count("sincosf(") for line in lines) == sites
    assert not any("sinf(" in line or " cosf(" in line for line in lines)
    # the counts are of operations run, the loops' bodies times their trips,
    # and equal the unrolled form's: the bound's yardstick does not move
    assert a.prologue_ops == unrolled.prologue_ops and a.substep_ops == unrolled.substep_ops
    assert a.ops_per_env == sum(a.prologue_ops.values()) + 2 * sum(a.substep_ops.values()) == 15085
    assert a.substep_ops["sin"] == a.substep_ops["cos"] == len(world.bodies.inv_mass) + world.position_iterations * (
        len(world.contacts.body) + 2 * len(world.joints.body_a))
    # the unrolled text has a statement for each operation
    statements = sum(line.strip().startswith(("const float t", "const bool t")) for line in unrolled.text.splitlines())
    assert statements == sum(a.prologue_ops.values()) + sum(a.substep_ops.values())
    assert len(a.text.splitlines()) * 3 < len(unrolled.text.splitlines())
    # the external-force terms are hoisted out of the substep loop
    assert a.prologue_ops == {"mul": 9}
    # one terrain lookup a contact before the velocity pass and one in each
    # position iteration, each a floor and a select over the 9 inner chunks
    lookups = len(world.contacts.body) * (1 + world.position_iterations)
    assert a.substep_ops["floor"] == lookups and a.substep_ops["ge"] == 9 * lookups
    assert step.source.ops_per_env == a.ops_per_env


def test_unrolled_trace_is_the_first_port_program():
    """The probe's unrolled form is the program the kernel's first port
    emitted: 7,809 lines, no solver loop, 59 ``sinf`` and 59 ``cosf``."""
    step = dyn.lander_step(-10.0)
    unrolled = unrolled_step(step)
    assert unrolled.build_name != step.build_name
    lines = [line.strip() for line in unrolled.source.text.splitlines()]
    assert len(lines) == 7809 and not any(line.startswith("for (int it") for line in lines)
    text = unrolled.source.text
    assert text.count("= sinf(") == text.count("= cosf(") == 59 and "sincosf(" not in text
    assert unrolled.source.ops_per_env == step.source.ops_per_env == 15085


def test_build_name_carries_gravity():
    default, low = dyn.lander_step(-10.0), dyn.lander_step(-3.7)
    assert default.build_name != low.build_name
    assert "m10p0" in default.build_name and "m3p7" in low.build_name
    assert default.source.text != low.source.text


def test_generator_refuses_joint_correction_clamp():
    """The walker's world sets the clamp; the solver here has no bounded
    sub-pull, so it refuses such a world instead of dropping the clamp."""
    world = dyn.build_lander_world()._replace(joint_correction_clamp=0.2)
    args = (world, dyn.CHUNKS, dyn.W / (dyn.CHUNKS - 1), dyn._MOTOR_SPEED, dyn._MOTOR_TORQUE)
    with pytest.raises(NotImplementedError, match="joint_correction_clamp"):
        generate_planar_source(*args, 2, "walker")
    with pytest.raises(NotImplementedError, match="joint_correction_clamp"):
        planar_step.make_fused_planar_step(*args)


def test_cpu_step_runs_the_twin_and_launches_nothing(inputs):
    step = dyn.lander_step(-10.0)
    ins = [torch.from_numpy(x[:33]) for x in inputs]
    before = dict(planar_step.launches)
    out = step(*ins)
    ref = step.reference(*ins)
    assert planar_step.launches == before
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert out[0].shape == (33, 3, 6) and out[0].dtype == torch.float32
    assert out[3].shape == (33, 10) and out[3].dtype == torch.bool


@pytest.mark.parametrize("bad", ["body_width", "terrain_chunks", "cimp_batch", "one_dim", "int_terrain"])
def test_step_rejects_bad_shapes(inputs, bad):
    step = dyn.lander_step(-10.0)
    bodies, ext, terrain, jimp, cimp = (torch.from_numpy(x[:8]) for x in inputs)
    if bad == "body_width":
        bodies = bodies[:, :, :5]
    elif bad == "terrain_chunks":
        terrain = terrain[:, :-1]
    elif bad == "cimp_batch":
        cimp = cimp[:-1]
    elif bad == "one_dim":
        bodies = bodies.reshape(-1)
    else:
        terrain = terrain.to(torch.int32)
    with pytest.raises(ValueError):
        step(bodies, ext, terrain, jimp, cimp)
