"""Generator of the planar (Box2D-class) substep, over two backends.

Counterpart of the generator inside the JAX package's
``ops/pallas_planar.py::make_fused_planar_step``. From the static tables of a
:class:`~gymnasium_tpu_torch.physics.planar.PlanarWorld` it writes one tick
of the sequential-impulse solver as scalar code:

- gravity and external forces integrate into the velocities;
- the joint impulses ``[motor, low, up, px, py]`` and the contact impulses
  ``[normal, tangent]`` warm-start the velocities; a contact whose depth is
  not positive drops its stored impulse;
- the velocity iterations solve, for each joint, the motor (its accumulated
  impulse clamped to ``torque * dt``), the lower and upper limits and the
  2x2 point constraint; then, for each contact, the normal impulse and the
  Coulomb-clamped tangent impulse;
- positions integrate;
- the non-linear Gauss-Seidel position iterations correct contacts first
  (Baumgarte, slop, max correction), then each joint's limit overshoot
  (clamped to 8 degrees) and its point error;
- the ground is the piecewise-linear chunk terrain of the env, read through
  an unrolled select over the chunk index.

The program is written once over the ops namespace of
:mod:`gymnasium_tpu_torch.ops.codegen`, in the JAX row program's order and
with its constant forms (``px * (1.0 / spacing)``, ``(ms - rel) * (1.0 /
k_ang)``, the clip top ``chunks - 1 - 1e-6``), so over ``TorchOps`` it is
the plain twin and over ``SymOps`` :func:`generate_planar_source` emits the
kernel's C text.

The emitted text keeps the velocity and position iterations as two C loops
(``ops.repeat``) and takes each angle's sine and cosine from one
``sincosf``. For the lander that is 2.0k statements instead of the 7.5k of
the iterations unrolled, and on an H100 a fifth of the machine code, which
runs about twice as fast (PERF.md). The unrolled program runs the same
operations, with the same rounding.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from gymnasium_tpu_torch.ops.codegen import (
    GeneratedSource,
    Sym,
    SymOps,
    _live,
    _ref,
    emit,
    op_counts,
)
from gymnasium_tpu_torch.physics.planar import PlanarWorld

__all__ = [
    "PlanarTables",
    "planar_tables",
    "make_substep",
    "generate_planar_source",
]

_MAX_ANG_CORR = 8.0 * 3.14159265 / 180.0  # b2_maxAngularCorrection


@dataclasses.dataclass(frozen=True)
class PlanarTables:
    """The static constants of one world and its terrain, as python floats."""

    nbody: int
    njoint: int
    ncontact: int
    chunks: int
    spacing: float
    substeps: int
    velocity_iterations: int
    position_iterations: int
    dt: float
    gravity: float
    inv_m: list
    inv_i: list
    anchor_a: list  # [J][2]
    anchor_b: list  # [J][2]
    j_a: list
    j_b: list
    j_lower: list
    j_upper: list
    j_ref: list
    c_body: list
    c_point: list  # [C][2]
    c_mu: list
    motor_speed: list
    motor_torque: list
    baumgarte: float
    slop: float
    max_corr: float


def planar_tables(
    world: PlanarWorld,
    chunks: int,
    spacing: float,
    motor_speed,
    motor_torque,
    substeps: int = 2,
) -> PlanarTables:
    """Fold the world's tables into python floats, as the JAX generator does.

    Raises ``NotImplementedError`` for a world with a joint correction clamp:
    the solver here (and the TPU kernel it mirrors) solves the full point
    error an iteration and would drop the clamp silently.
    """
    if float(world.joint_correction_clamp) != 0.0:
        raise NotImplementedError(
            f"joint_correction_clamp={world.joint_correction_clamp}: the generated planar "
            "substep solves the full joint point error an iteration and has no bounded sub-pull"
        )
    if substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    if chunks < 2:
        raise ValueError(f"the terrain needs at least 2 chunks, got {chunks}")
    anchor_a = np.asarray(world.joints.anchor_a, np.float64)
    anchor_b = np.asarray(world.joints.anchor_b, np.float64)
    c_point = np.asarray(world.contacts.point, np.float64)
    return PlanarTables(
        nbody=len(world.bodies.inv_mass),
        njoint=len(world.joints.body_a),
        ncontact=len(world.contacts.body),
        chunks=int(chunks),
        spacing=float(spacing),
        substeps=int(substeps),
        velocity_iterations=int(world.velocity_iterations),
        position_iterations=int(world.position_iterations),
        dt=float(world.dt),
        gravity=float(world.gravity),
        inv_m=[float(v) for v in world.bodies.inv_mass],
        inv_i=[float(v) for v in world.bodies.inv_inertia],
        anchor_a=[[float(v) for v in row] for row in anchor_a],
        anchor_b=[[float(v) for v in row] for row in anchor_b],
        j_a=[int(v) for v in world.joints.body_a],
        j_b=[int(v) for v in world.joints.body_b],
        j_lower=[float(v) for v in world.joints.lower],
        j_upper=[float(v) for v in world.joints.upper],
        j_ref=[float(v) for v in world.joints.ref_angle],
        c_body=[int(v) for v in world.contacts.body],
        c_point=[[float(v) for v in row] for row in c_point],
        c_mu=[float(v) for v in world.contacts.friction],
        motor_speed=[float(v) for v in np.asarray(motor_speed)],
        motor_torque=[float(v) for v in np.asarray(motor_torque)],
        baumgarte=float(world.baumgarte),
        slop=float(world.contact_slop),
        max_corr=float(world.max_correction),
    )


def make_substep(t: PlanarTables, ops):
    """One solver tick ``(body, ext, t_rows, jimp, cimp) -> (body', jimp',
    cimp', flags)`` over lists of per-env values: ``body`` [B][6], ``ext``
    [B][3], ``t_rows`` [chunks], ``jimp`` [J][5], ``cimp`` [C][2]. The flags
    are the pre-step ``depth > 0`` of each contact. The solver iterations
    run through ``ops.repeat``, each angle's sine and cosine through
    ``ops.sincos``."""
    B, J, C, chunks = t.nbody, t.njoint, t.ncontact, t.chunks
    dt, g, inv_m, inv_i = t.dt, t.gravity, t.inv_m, t.inv_i
    j_a, j_b, ms, mt = t.j_a, t.j_b, t.motor_speed, t.motor_torque
    clip_top = chunks - 1 - 1e-6

    def ground_segment(t_rows, px):
        """The terrain segment under ``px``: ``(h0, slope, i0)`` with
        ``gy = h0 + (px / spacing - i0) * slope``, by an unrolled select."""
        xc = ops.clip(px * (1.0 / t.spacing), 0.0, clip_top)
        i0 = ops.floor(xc)
        h0 = t_rows[0]
        h1 = t_rows[1]
        for i in range(1, chunks - 1):
            sel = i0 >= i
            h0 = ops.where(sel, t_rows[i], h0)
            h1 = ops.where(sel, t_rows[min(i + 1, chunks - 1)], h1)
        return h0, h1 - h0, i0

    def seg_eval(seg, px):
        h0, slope, i0 = seg
        xc = ops.clip(px * (1.0 / t.spacing), 0.0, clip_top)
        return h0 + (xc - i0) * slope

    def substep(body, ext, t_rows, jimp, cimp):
        x = [body[b][0] for b in range(B)]
        y = [body[b][1] for b in range(B)]
        ang = [body[b][2] for b in range(B)]
        vx = [body[b][3] for b in range(B)]
        vy = [body[b][4] for b in range(B)]
        w = [body[b][5] for b in range(B)]

        # --- integrate gravity + external forces ------------------------------
        for b in range(B):
            if inv_m[b] > 0:
                vy[b] = vy[b] + g * dt
                vx[b] = vx[b] + ext[b][0] * (inv_m[b] * dt)
                vy[b] = vy[b] + ext[b][1] * (inv_m[b] * dt)
                w[b] = w[b] + ext[b][2] * (inv_i[b] * dt)

        pairs = [ops.sincos(a) for a in ang]
        sin, cos = [s for s, _ in pairs], [c for _, c in pairs]

        # joint anchor arms (pre-step pose)
        arms = []
        for j in range(J):
            a, b = j_a[j], j_b[j]
            ax, ay = t.anchor_a[j]
            bx, by = t.anchor_b[j]
            rax = ax * cos[a] - ay * sin[a]
            ray = ax * sin[a] + ay * cos[a]
            rbx = bx * cos[b] - by * sin[b]
            rby = bx * sin[b] + by * cos[b]
            arms.append((a, b, rax, ray, rbx, rby))

        # contact probes: world arm, depth, frozen terrain segment
        cdata = []
        for k in range(C):
            b = t.c_body[k]
            px_, py_ = t.c_point[k]
            rx = px_ * cos[b] - py_ * sin[b]
            ry = px_ * sin[b] + py_ * cos[b]
            wx = x[b] + rx
            wy = y[b] + ry
            seg = ground_segment(t_rows, wx)
            depth = seg_eval(seg, wx) - wy
            cdata.append((b, rx, ry, depth, seg))
        flags = [cd[3] > 0.0 for cd in cdata]

        # --- warm starting (Box2D b2Island::initVelocityConstraints) ----------
        acc_m = [jimp[j][0] for j in range(J)]
        acc_lo = [jimp[j][1] for j in range(J)]
        acc_up = [jimp[j][2] for j in range(J)]
        acc_jx = [jimp[j][3] for j in range(J)]
        acc_jy = [jimp[j][4] for j in range(J)]
        for j in range(J):
            a, b, rax, ray, rbx, rby = arms[j]
            ang_l = acc_m[j] + acc_lo[j] + acc_up[j]
            px_, py_ = acc_jx[j], acc_jy[j]
            vx[a] = vx[a] - px_ * inv_m[a]
            vy[a] = vy[a] - py_ * inv_m[a]
            vx[b] = vx[b] + px_ * inv_m[b]
            vy[b] = vy[b] + py_ * inv_m[b]
            w[a] = w[a] - ((rax * py_ - ray * px_) + ang_l) * inv_i[a]
            w[b] = w[b] + ((rbx * py_ - rby * px_) + ang_l) * inv_i[b]
        acc_n = [None] * C
        acc_t = [None] * C
        for k in range(C):
            b, rx, ry, depth, _ = cdata[k]
            live = depth > 0.0
            jn = ops.where(live, cimp[k][0], 0.0)
            jt = ops.where(live, cimp[k][1], 0.0)
            acc_n[k], acc_t[k] = jn, jt
            vx[b] = vx[b] + jt * inv_m[b]
            vy[b] = vy[b] + jn * inv_m[b]
            w[b] = w[b] + (rx * jn - ry * jt) * inv_i[b]

        # --- velocity iterations ------------------------------------------------
        def velocity_iteration(carried):
            vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(
                carried, (B, B, B, J, J, J, J, J, C, C)
            )
            for j in range(J):
                a, b, rax, ray, rbx, rby = arms[j]
                k_ang = max(inv_i[a] + inv_i[b], 1e-9)

                # motor toward its target relative speed, total impulse
                # clamped to maxMotorTorque * dt
                rel = w[b] - w[a]
                raw = (ms[j] - rel) * (1.0 / k_ang)
                max_imp = mt[j] * dt
                new_acc = ops.clip(acc_m[j] + raw, -max_imp, max_imp)
                imp = new_acc - acc_m[j]
                acc_m[j] = new_acc
                w[a] = w[a] - imp * inv_i[a]
                w[b] = w[b] + imp * inv_i[b]

                # limits: block velocity into a violated limit
                j_angle = ang[b] - ang[a] - t.j_ref[j]
                rel = w[b] - w[a]
                at_lower = j_angle - t.j_lower[j] < 0
                raw = ops.where(at_lower, -rel * (1.0 / k_ang), -acc_lo[j])
                new_acc = ops.maximum(acc_lo[j] + raw, 0.0)
                imp = new_acc - acc_lo[j]
                acc_lo[j] = new_acc
                w[a] = w[a] - imp * inv_i[a]
                w[b] = w[b] + imp * inv_i[b]
                rel = w[b] - w[a]
                at_upper = t.j_upper[j] - j_angle < 0
                raw = ops.where(at_upper, -rel * (1.0 / k_ang), -acc_up[j])
                new_acc = ops.minimum(acc_up[j] + raw, 0.0)
                imp = new_acc - acc_up[j]
                acc_up[j] = new_acc
                w[a] = w[a] - imp * inv_i[a]
                w[b] = w[b] + imp * inv_i[b]

                # point constraint (2x2 solve)
                vax = vx[a] - w[a] * ray
                vay = vy[a] + w[a] * rax
                vbx = vx[b] - w[b] * rby
                vby = vy[b] + w[b] * rbx
                cdx = vbx - vax
                cdy = vby - vay
                k11 = inv_m[a] + inv_m[b] + inv_i[a] * ray * ray + inv_i[b] * rby * rby
                k12 = -inv_i[a] * rax * ray - inv_i[b] * rbx * rby
                k22 = inv_m[a] + inv_m[b] + inv_i[a] * rax * rax + inv_i[b] * rbx * rbx
                det = k11 * k22 - k12 * k12
                det = ops.where(ops.abs(det) < 1e-12, 1e-12, det)
                ix = -(k22 * cdx - k12 * cdy) / det
                iy = -(k11 * cdy - k12 * cdx) / det
                acc_jx[j] = acc_jx[j] + ix
                acc_jy[j] = acc_jy[j] + iy
                vx[a] = vx[a] - ix * inv_m[a]
                vy[a] = vy[a] - iy * inv_m[a]
                vx[b] = vx[b] + ix * inv_m[b]
                vy[b] = vy[b] + iy * inv_m[b]
                w[a] = w[a] - (rax * iy - ray * ix) * inv_i[a]
                w[b] = w[b] + (rbx * iy - rby * ix) * inv_i[b]

            for k in range(C):
                b, rx, ry, depth, _ = cdata[k]
                active = depth > 0.0
                pvy = vy[b] + w[b] * rx
                k_n = ops.maximum(inv_m[b] + inv_i[b] * rx * rx, 1e-9)
                raw_n = ops.where(active, -pvy / k_n, -acc_n[k])
                na = ops.maximum(acc_n[k] + raw_n, 0.0)
                jn = na - acc_n[k]
                acc_n[k] = na
                vy[b] = vy[b] + jn * inv_m[b]
                w[b] = w[b] + rx * jn * inv_i[b]

                pvx = vx[b] - w[b] * ry
                k_t = ops.maximum(inv_m[b] + inv_i[b] * ry * ry, 1e-9)
                raw_t = ops.where(active, -pvx / k_t, -acc_t[k])
                ta = ops.clip(acc_t[k] + raw_t, -t.c_mu[k] * na, t.c_mu[k] * na)
                jt = ta - acc_t[k]
                acc_t[k] = ta
                vx[b] = vx[b] + jt * inv_m[b]
                w[b] = w[b] - ry * jt * inv_i[b]
            return vx + vy + w + acc_m + acc_lo + acc_up + acc_jx + acc_jy + acc_n + acc_t

        carried = ops.repeat(
            t.velocity_iterations,
            vx + vy + w + acc_m + acc_lo + acc_up + acc_jx + acc_jy + acc_n + acc_t,
            velocity_iteration,
        )
        vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(
            carried, (B, B, B, J, J, J, J, J, C, C)
        )

        # --- integrate positions -------------------------------------------------
        for b in range(B):
            x[b] = x[b] + vx[b] * dt
            y[b] = y[b] + vy[b] * dt
            ang[b] = ang[b] + w[b] * dt

        # --- position pass (contacts first, then joints) ------------------------
        def position_iteration(carried):
            x, y, ang = _split(carried, (B, B, B))
            for k in range(C):
                b = t.c_body[k]
                px_, py_ = t.c_point[k]
                sb, cb = ops.sincos(ang[b])
                rx = px_ * cb - py_ * sb
                ry = px_ * sb + py_ * cb
                wx = x[b] + rx
                wy = y[b] + ry
                seg = ground_segment(t_rows, wx)
                depth = seg_eval(seg, wx) - wy
                corr = ops.clip(t.baumgarte * (depth - t.slop), 0.0, t.max_corr)
                k_n = ops.maximum(inv_m[b] + inv_i[b] * rx * rx, 1e-9)
                lam = corr / k_n
                y[b] = y[b] + lam * inv_m[b]
                ang[b] = ang[b] + rx * lam * inv_i[b]

            for j in range(J):
                a, b = j_a[j], j_b[j]
                k_ang = max(inv_i[a] + inv_i[b], 1e-9)
                j_angle = ang[b] - ang[a] - t.j_ref[j]
                over_low = ops.minimum(j_angle - t.j_lower[j], 0.0)
                over_up = ops.maximum(j_angle - t.j_upper[j], 0.0)
                corr = ops.clip(-(over_low + over_up), -_MAX_ANG_CORR, _MAX_ANG_CORR)
                ang[a] = ang[a] - corr * (inv_i[a] / k_ang)
                ang[b] = ang[b] + corr * (inv_i[b] / k_ang)

                sa, ca = ops.sincos(ang[a])
                sb, cb = ops.sincos(ang[b])
                ax_, ay_ = t.anchor_a[j]
                bx_, by_ = t.anchor_b[j]
                rax = ax_ * ca - ay_ * sa
                ray = ax_ * sa + ay_ * ca
                rbx = bx_ * cb - by_ * sb
                rby = bx_ * sb + by_ * cb
                errx = (x[b] + rbx) - (x[a] + rax)
                erry = (y[b] + rby) - (y[a] + ray)
                k11 = inv_m[a] + inv_m[b] + inv_i[a] * ray * ray + inv_i[b] * rby * rby
                k12 = -inv_i[a] * rax * ray - inv_i[b] * rbx * rby
                k22 = inv_m[a] + inv_m[b] + inv_i[a] * rax * rax + inv_i[b] * rbx * rbx
                det = k11 * k22 - k12 * k12
                det = ops.where(ops.abs(det) < 1e-12, 1e-12, det)
                ix = -(k22 * errx - k12 * erry) / det
                iy = -(k11 * erry - k12 * errx) / det
                x[a] = x[a] - ix * inv_m[a]
                y[a] = y[a] - iy * inv_m[a]
                x[b] = x[b] + ix * inv_m[b]
                y[b] = y[b] + iy * inv_m[b]
                ang[a] = ang[a] - (rax * iy - ray * ix) * inv_i[a]
                ang[b] = ang[b] + (rbx * iy - rby * ix) * inv_i[b]
            return x + y + ang

        carried = ops.repeat(t.position_iterations, x + y + ang, position_iteration)
        x, y, ang = _split(carried, (B, B, B))

        body_out = [[x[b], y[b], ang[b], vx[b], vy[b], w[b]] for b in range(B)]
        jimp_out = [[acc_m[j], acc_lo[j], acc_up[j], acc_jx[j], acc_jy[j]] for j in range(J)]
        cimp_out = [[acc_n[k], acc_t[k]] for k in range(C)]
        return body_out, jimp_out, cimp_out, flags

    return substep


def _split(values, sizes):
    """``values`` cut into consecutive lists of the given sizes."""
    out, start = [], 0
    for size in sizes:
        out.append(list(values[start : start + size]))
        start += size
    return out


def generate_planar_source(
    world: PlanarWorld,
    chunks: int,
    spacing: float,
    motor_speed,
    motor_torque,
    substeps: int,
    name: str,
) -> GeneratedSource:
    """Emit the kernel source of ``substeps`` solver ticks of ``world``.

    The text defines ``struct PlanarStep`` with the widths and a
    ``__host__ __device__`` ``run(body, ext, terrain, jimp, cimp, flags)``
    that steps one env in registers, then instantiates the fixed kernel and
    entry points of ``csrc/planar_step.cuh``. Under ``nvcc`` that gives the
    launcher ``planar_step_launch``; under a plain C++ compiler the host loop
    ``planar_step_host``. Raises ``NotImplementedError`` for a world with a
    joint correction clamp (:func:`planar_tables`).
    """
    t = planar_tables(world, chunks, spacing, motor_speed, motor_torque, substeps)
    B, J, C = t.nbody, t.njoint, t.ncontact
    ops = SymOps()
    ext = [[ops.input(f"e{3 * b + i}", varying=False) for i in range(3)] for b in range(B)]
    t_rows = [ops.input(f"h{i}", varying=False) for i in range(chunks)]
    body = [[ops.input(f"s{6 * b + i}", varying=True) for i in range(6)] for b in range(B)]
    jimp = [[ops.input(f"j{5 * j + i}", varying=True) for i in range(5)] for j in range(J)]
    cimp = [[ops.input(f"k{2 * k + i}", varying=True) for i in range(2)] for k in range(C)]
    body_out, jimp_out, cimp_out, flags = make_substep(t, ops)(body, ext, t_rows, jimp, cimp)
    state_out = [v for row in body_out + jimp_out + cimp_out for v in row]
    outputs = [x if isinstance(x, Sym) else ops.const(x) for x in state_out + flags]

    live = _live(outputs)
    outer = [n for n in live if n.scope is None]
    prologue = [n for n in outer if not n.varying]
    loop = [n for n in outer if n.varying]
    inner = [n for n in live if n.scope is not None]
    prologue_ops = op_counts(prologue)
    substep_ops = op_counts(loop + inner)

    def counts(c):
        return ", ".join(f"{k} {v}" for k, v in sorted(c.items()))

    n_body, n_jimp, n_cimp = 6 * B, 5 * J, 2 * C
    state = (
        [f"s{i}" for i in range(n_body)]
        + [f"j{i}" for i in range(n_jimp)]
        + [f"k{i}" for i in range(n_cimp)]
    )
    ind2, ind3 = " " * 4, " " * 6
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/planar_codegen.py for {name},",
        f"// substeps {substeps}. Do not edit: edit the generator.",
        f"// Once a call: {counts(prologue_ops) or 'nothing'}.",
        f"// Each substep: {counts(substep_ops)}.",
        '#include "planar_step.cuh"',
        "",
        "struct PlanarStep {",
        f"  static constexpr int kBodies = {B};",
        f"  static constexpr int kJoints = {J};",
        f"  static constexpr int kContacts = {C};",
        f"  static constexpr int kChunks = {chunks};",
        "  static PLANAR_FN void run(float* body, const float* ext, const float* terrain,",
        "                            float* jimp, float* cimp, bool* flags) {",
    ]
    lines += [f"{ind2}const float e{i} = ext[{i}];" for i in range(3 * B)]
    lines += [f"{ind2}const float h{i} = terrain[{i}];" for i in range(chunks)]
    lines += emit(prologue, live, ind2, "PLANAR_NO_UNROLL")
    lines += [f"{ind2}float s{i} = body[{i}];" for i in range(n_body)]
    lines += [f"{ind2}float j{i} = jimp[{i}];" for i in range(n_jimp)]
    lines += [f"{ind2}float k{i} = cimp[{i}];" for i in range(n_cimp)]
    lines += [f"{ind2}bool f{k} = false;" for k in range(C)]
    lines += [f"{ind2}PLANAR_NO_UNROLL", f"{ind2}for (int sub = 0; sub < {substeps}; ++sub) {{"]
    lines += emit(loop, live, ind3, "PLANAR_NO_UNROLL")
    new_state = outputs[: len(state)]
    lines += [f"{ind3}const float n{var} = {_ref(o)};" for var, o in zip(state, new_state)]
    lines += [f"{ind3}{var} = n{var};" for var in state]
    lines += [f"{ind3}f{k} = {_ref(o)};" for k, o in enumerate(outputs[len(state) :])]
    lines += [f"{ind2}}}"]
    lines += [f"{ind2}body[{i}] = s{i};" for i in range(n_body)]
    lines += [f"{ind2}jimp[{i}] = j{i};" for i in range(n_jimp)]
    lines += [f"{ind2}cimp[{i}] = k{i};" for i in range(n_cimp)]
    lines += [f"{ind2}flags[{k}] = f{k};" for k in range(C)]
    lines += ["  }", "};", "", "PLANAR_ENTRY_POINTS(PlanarStep)", ""]
    return GeneratedSource(name, substeps, "\n".join(lines), prologue_ops, substep_ops)
