"""The planar (Box2D-class) solver step of the port against the JAX package.

The inputs are ``chip_smoke.planar_states``: the lander states of
``tests/ops/test_pallas_planar.py::_random_lander_states``, lanes with the
legs at the ground, the creation pose (the reset tick's input) and lanes deep
in the ground beyond both ends of the terrain, so every side of the solver is
reached (asserted). Three comparisons on the lander's world:

- the plain twin (the generator over torch tensors) against the JAX row
  program ``make_fused_planar_step(...).rows_step``, run eagerly under
  ``jnp``. That is the Pallas kernel's own arithmetic;
- the twin against JAX ``world_step`` chained over both substeps, at the
  JAX kernel test's tolerances (``test_pallas_planar.py:107-110``);
- the generated kernel source compiled for the host with ``g++`` (the same
  text ``nvcc`` builds, whose ``run`` is ``__host__ __device__``) against the
  twin, and against the same program emitted with its solver iterations
  unrolled (``tools/port_planar_probe.py::unrolled_step``), bit for bit.

Then the world of BipedalWalker (``chip_smoke.walker_states``: the creation
pose with its hips 0.53 m from their anchors, assembled poses at, in and
above the ground past joint limits, live warm-start contact impulses): the
walker's fused step against four ticks of the port's ``world_step`` (one
solver program), and the walker's emitted source built with ``g++`` against
its twin. The lander's world with the sub-pull clamp is held to JAX's
``world_step`` over numpy, and the port's ``world_step`` on the lander's
world to JAX's; ``tests/test_torch_bipedal_walker.py`` holds it to one
eager ``jnp`` tick of JAX's on the walker's world.

Each case states its tolerance and records the largest deviation it saw.
Flags are compared exactly.
"""

import ctypes
import hashlib
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu.envs.dynamics.lunar_lander as L
import gymnasium_tpu.envs.box2d.bipedal_walker as BW
from chip_smoke import planar_branch_lanes, planar_states, walker_states
from gymnasium_tpu.ops.pallas_planar import make_fused_planar_step as jax_make_fused_planar_step
from gymnasium_tpu.physics.planar import world_step
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as walker
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.ops import planar_step
from gymnasium_tpu_torch.ops.build import SOURCE_DIR
from gymnasium_tpu_torch.ops.planar_codegen import ChunkTerrain, Heightfield, generate_planar_source
from gymnasium_tpu_torch.physics import planar as port_planar
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


@pytest.fixture(scope="module")
def jax_chained(inputs):
    """Both substeps of JAX's ``world_step`` on the lander inputs, warm
    starts and external forces included, as
    ``test_pallas_planar.py::test_fused_planar_matches_world_step`` chains them."""
    bodies, ext, terrain, jimp, cimp = (jnp.asarray(x) for x in inputs)
    world = L._lander_world(-10.0)
    gh = lambda px: L.ground_height(jnp, terrain, px)  # noqa: E731
    warm, flags = (jimp, cimp), None
    for _ in range(L._SUBSTEPS):
        bodies, flags, warm = world_step(
            jnp, bodies, world, jnp.asarray(L._MOTOR_SPEED), jnp.asarray(L._MOTOR_TORQUE), gh,
            external_force=ext, warm_start=warm,
        )
    return tuple(np.asarray(x) for x in (bodies, warm[0], warm[1], flags))


def test_twin_matches_chained_world_step(request, twin, jax_chained):
    _check(request, twin, jax_chained, ENGINE_TOL)


def _lander_ground(terrain):
    """The lander's terrain lookup of the JAX module, over torch tensors."""
    spacing = dyn.W / (dyn.CHUNKS - 1)

    def f(x):
        xc = torch.clamp(x / spacing, 0.0, dyn.CHUNKS - 1 - 1e-6)
        i0 = torch.floor(xc)
        h0 = terrain.gather(1, i0.long()[:, None])[:, 0]
        h1 = terrain.gather(1, torch.clamp(i0.long() + 1, max=dyn.CHUNKS - 1)[:, None])[:, 0]
        return h0 + (h1 - h0) * (xc - i0)

    return f


def test_port_world_step_matches_chained_jax_world_step(request, inputs, jax_chained):
    """The port's batched ``world_step`` chained over both substeps of the
    lander's world, with its own callable ground, against JAX's: the JAX
    kernel test's tolerances."""
    bodies, ext, terrain, jimp, cimp = (torch.from_numpy(x) for x in inputs)
    warm, flags = (jimp, cimp), None
    for _ in range(dyn._SUBSTEPS):
        bodies, flags, warm = port_planar.world_step(
            bodies, dyn._lander_world(-10.0), dyn._MOTOR_SPEED, dyn._MOTOR_TORQUE, _lander_ground(terrain),
            external_force=ext, warm_start=warm,
        )
    got = tuple(x.numpy() for x in (bodies, warm[0], warm[1], flags))
    _check(request, got, jax_chained, ENGINE_TOL)


def _host_run(tmp_path, text, inputs, motors=(None, None)):
    """Build an emitted source with the host ``g++`` and run it on ``inputs``
    (bodies, external, terrain, jimp, cimp; None for a part the world
    lacks) and the per-env ``motors`` (speeds, torques) where it takes them.

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
    host_step.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int]
    ins = [None if x is None else np.ascontiguousarray(x, np.float32) for x in (*inputs, *motors)]
    n = ins[0].shape[0]
    outs = [np.empty_like(ins[0]), None if ins[3] is None else np.empty_like(ins[3]), np.empty_like(ins[4]),
            np.empty((n, ins[4].shape[1]), np.bool_)]
    host_step(*(None if x is None else x.ctypes.data for x in ins + outs), n)
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
    args = (world, ChunkTerrain(11, dyn.W / 10), (dyn._MOTOR_SPEED, dyn._MOTOR_TORQUE), 2, True, True, "x")
    # the build's own layout, a lane a body, runs the same operations as
    # the one-thread form, whose text the checks below read
    chosen = generate_planar_source(*args)
    assert chosen.text == generate_planar_source(*args).text == step.source.text.replace(step.name, "x")
    assert chosen.layout["lanes"] == 4 and "static constexpr int kLanes = 4;" in chosen.text
    a = generate_planar_source(*args, lanes=1)
    assert (chosen.prologue_ops, chosen.substep_ops) == (a.prologue_ops, a.substep_ops)
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
    # the shipped 4-lane text keeps that structure: the same rolled loops,
    # every sine and cosine from one PL_SINCOS a phase (one for the bodies
    # before the velocity pass; in a position iteration one for each of the
    # hull's six probes, which run on its lane one after another, and two for
    # each joint, both on the hull), and the external terms hoisted
    shipped = [line.strip() for line in chosen.text.splitlines()]
    sub = shipped.index("for (int sub = 0; sub < 2; ++sub) {")
    assert shipped[sub - 1] == "PLANAR_NO_UNROLL"
    for iterations in (world.velocity_iterations, world.position_iterations):
        loop = f"for (int it = 0; it < {iterations}; ++it) {{"
        assert shipped.count(loop) == 1 and shipped[shipped.index(loop) - 1] == "PLANAR_NO_UNROLL"
    hull_probes = list(world.contacts.body).count(0)
    assert sum(line.count("PL_SINCOS(") for line in shipped) == 1 + hull_probes + 2 * len(world.joints.body_a) == 11
    assert not any("sincosf(" in line or "sinf(" in line or " cosf(" in line for line in shipped)
    reads_ext = [i for i, line in enumerate(shipped) if re.search(r"\be\d+\b", line)]
    assert reads_ext and max(reads_ext) < sub


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


def test_generator_refuses_joint_correction_clamp(request, inputs):
    """The generator no longer refuses a world with a joint correction clamp:
    it pulls each joint's point error at most the clamp an iteration, as
    ``physics/planar.py:374-383`` does. Here the lander's world with the
    walker's clamp, 0.2 m, two substeps of the fused step's twin against
    JAX's ``world_step`` over numpy (float64; float32 rounding is inside the
    kernel test's tolerances). Every lane of the inputs has a leg past the
    clamp from its hip; here the lanes of group 0 get their legs moved onto
    their hip anchors, so they stay under it. The clamp moves the
    creation-pose lanes' result."""
    world = dyn.build_lander_world()._replace(joint_correction_clamp=0.2)
    terrain_layout = ChunkTerrain(dyn.CHUNKS, dyn.W / (dyn.CHUNKS - 1))
    motors = (dyn._MOTOR_SPEED, dyn._MOTOR_TORQUE)
    step = planar_step.FusedPlanarStep(world, terrain_layout, motors, name="lander_clamped")
    inputs = [x.copy() for x in inputs]
    bodies = inputs[0]
    assembled = np.arange(N) % 4 == 0
    hull = bodies[assembled, 0].astype(np.float64)
    for leg, (ax, ay), (bx, by) in zip((1, 2), world.joints.anchor_a, world.joints.anchor_b):
        c, s_ = np.cos(hull[:, 2]), np.sin(hull[:, 2])
        hip = (hull[:, 0] + ax * c - ay * s_, hull[:, 1] + ax * s_ + ay * c)
        a = bodies[assembled, leg, 2].astype(np.float64)
        bodies[assembled, leg, 0] = hip[0] - (bx * np.cos(a) - by * np.sin(a))
        bodies[assembled, leg, 1] = hip[1] - (bx * np.sin(a) + by * np.cos(a))
    ins = [torch.from_numpy(x) for x in inputs]
    lanes = planar_branch_lanes(step, *ins)
    assert lanes["clamped_joint_pull"] > 0 and lanes["unclamped_joint_pull"] > 0, lanes
    got = tuple(x.numpy() for x in step(*ins))

    bodies, ext, terrain, jimp, cimp = (x.astype(np.float64) for x in inputs)
    gh = lambda px: L.ground_height(np, terrain, px)  # noqa: E731
    warm, flags = (jimp, cimp), None
    for _ in range(2):
        bodies, flags, warm = world_step(
            np, bodies, world, L._MOTOR_SPEED, L._MOTOR_TORQUE, gh, external_force=ext, warm_start=warm
        )
    _check(request, got, (bodies, warm[0], warm[1], flags), ENGINE_TOL)
    unclamped = dyn.lander_step(-10.0)(*ins)[0].numpy()
    pose = np.arange(N) % 4 == 2
    assert np.abs(got[0][pose] - unclamped[pose]).max() > 1e-2


@pytest.fixture(scope="module")
def walker_inputs():
    return walker_states(32, "cpu", seed=2)


def test_walker_inputs_reach_every_side_of_the_solver(walker_inputs):
    counts = planar_branch_lanes(walker.walker_solver(), *walker_inputs)
    assert all(count > 0 for count in counts.values()), counts
    assert "clamped_joint_pull" in counts


def test_walker_step_twin_is_four_port_world_steps(walker_inputs):
    """One solver program: the walker's fused step (four ticks, joint
    impulses from zero each tick, contact impulses carried) gives the bits of
    four ticks of the port's ``world_step``."""
    bodies, _, terrain, _, cimp, ms, mt = walker_inputs
    out = walker.walker_solver()(*walker_inputs)
    assert out[1] is None
    jimp, flags = torch.zeros((bodies.shape[0], 4, 5)), None
    for _ in range(4):
        bodies, flags, (_, cimp) = port_planar.world_step(
            bodies, walker._WORLD, ms, mt, walker.ground_height_fn(terrain), warm_start=(jimp, cimp)
        )
    for got, want in zip((out[0], out[2], out[3]), (bodies, cimp, flags)):
        assert got.numpy().tobytes() == want.numpy().tobytes()


def test_walker_emitted_source_matches_twin_on_host(request, tmp_path, walker_inputs):
    """The walker's emitted source (per-env motors, the heightfield read by
    index, no joint impulse rows) built with ``g++`` against its twin. The
    host's ``sinf``/``cosf`` (glibc) and torch's CPU ``sin``/``cos`` differ
    in the last bit now and then, and four ticks of 20 iterations grow those
    bits (largest seen: 1.6e-5 in a body, on a lane sunk into the ground),
    so the values are held to the JAX kernel test's tolerances and the flags
    exactly; on the card, where the kernel's ``sincosf`` and torch's
    ``sin``/``cos`` round alike, ``chip_smoke.py`` holds them equal in every
    bit."""
    step = walker.walker_solver()
    twin = [None if x is None else x.numpy() for x in step(*walker_inputs)]
    ins = [None if x is None else x.numpy() for x in walker_inputs]
    host = _host_run(tmp_path, step.source.text, ins[:5], motors=ins[5:])
    assert host[1] is None
    zeros = np.zeros((len(twin[0]), 4, 5), np.float32)
    _check(request, (host[0], zeros, host[2], host[3]), (twin[0], zeros, twin[2], twin[3]), ENGINE_TOL)


def test_walker_generated_source_is_counted():
    """The walker's source: two indexed loads a terrain lookup (one before
    the velocity pass and one in each position iteration a probe), no
    select over chunks, the bounded sub-pull (a sqrt a joint a position
    iteration), the motors as inputs, and no joint impulse rows."""
    step = walker.walker_solver()
    src, world = step.source, walker._WORLD
    C, J = len(world.contacts.body), len(world.joints.body_a)
    lookups = C * (1 + world.position_iterations)
    assert src.substep_ops["load"] == 2 * lookups and src.substep_ops["floor"] == lookups
    assert "ge" not in src.substep_ops and src.substep_ops["sqrt"] == J * world.position_iterations
    assert src.prologue_ops == {"mul": J, "neg": J}  # each motor's torque * dt and its negative
    assert src.substeps == 4 and src.ops_per_env == sum(src.prologue_ops.values()) + 4 * sum(src.substep_ops.values())
    lines = [line.strip() for line in src.text.splitlines()]
    assert "static constexpr bool kMotors = true;" in lines and "static constexpr bool kJointCarry = false;" in lines
    assert sum(line.startswith("const float m") for line in lines) == 2 * J
    assert not any(line.startswith(("float j", "jimp[", "const float h", "const float e")) for line in lines)
    # the build's text: a probe phase a slot of the busiest body's probes
    # (four), before the loops and in the position loop's body
    assert src.layout["lanes"] == 8 and "static constexpr int kLanes = 8;" in lines
    slots = max(list(world.contacts.body).count(b) for b in range(len(world.bodies.inv_mass)))
    assert sum(line.count("terrain[(int)") for line in lines) == 2 * (slots + slots) == 16
    one = generate_planar_source(*step._args, step.name, lanes=1)
    assert (one.prologue_ops, one.substep_ops) == (src.prologue_ops, src.substep_ops)
    # one thread an env: a lookup a probe, before the loops and in the loop body
    assert sum(line.count("terrain[(int)") for line in one.text.splitlines()) == 2 * (C + C)
    assert step.build_name.startswith("planar_bipedal_walker_ss4_") and step.build_name != dyn.lander_step(-10.0).build_name
    assert planar_step.FusedPlanarStep(world, Heightfield(200, BW.TERRAIN_STEP), None, 2, False, False,
                                       name="bipedal_walker").build_name != step.build_name


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
