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
  (clamped to 8 degrees) and its point error, pulled at most
  ``joint_correction_clamp`` metres an iteration where the world sets one;
- the ground is the env's piecewise-linear terrain, in the env's own
  arithmetic: the lander's 11 chunks (:class:`ChunkTerrain`) through an
  unrolled select over the chunk index, the walker's 200-point heightfield
  (:class:`Heightfield`) by two indexed loads from the env's row.

What an env gives the solver is chosen by the world and the env: motor
speeds and torques are folded constants (the lander's leg springs) or
per-env inputs (the walker's action); an env that carries its joint
impulses from tick to tick (the lander) reads and writes them, one that
does not (the walker) starts every tick from zero joint impulses and writes
none; external forces are inputs only where the env applies them.

The program is written once over the ops namespace of
:mod:`gymnasium_tpu_torch.ops.codegen`, in the JAX row program's order and
with its constant forms (``px * (1.0 / spacing)``, ``(ms - rel) * (1.0 /
k_ang)``, the clip top ``chunks - 1 - 1e-6``), so over ``TorchOps`` it is
the plain twin (and, with a callable ground, the port's batched
``physics.planar.world_step``) and over ``SymOps``
:func:`generate_planar_source` emits the kernel's C text.

The emitted text keeps the velocity and position iterations as two C loops
(``ops.repeat``) and takes each angle's sine and cosine from one
``sincosf``. For the lander that is 2.0k statements instead of the 7.5k of
the iterations unrolled, and on an H100 a fifth of the machine code, which
runs about twice as fast (PERF.md). The unrolled program runs the same
operations, with the same rounding.

The program is traced in units (``ops.unit``): each body, contact probe and
joint. :class:`_LaneEmitter` lays one env over a group of lanes of a warp, a
body and its probes a lane: the solver's sweeps run body by body side by
side, each body's updates in the twin's order, and the lanes meet by
shuffles. :func:`generate_planar_source` picks the group's size from the
world by the schedule's estimate (:func:`lane_estimates`); one lane is the
one-thread form.
"""

from __future__ import annotations

import collections
import dataclasses

import numpy as np

from typing import TYPE_CHECKING

import torch

from gymnasium_tpu_torch.ops.codegen import (
    GeneratedSource,
    Sym,
    SymOps,
    TorchOps,
    _ctype,
    _expression,
    _literal,
    _live,
    emit,
    op_counts,
)
from gymnasium_tpu_torch.ops.warp_partition import LATENCY, SELECT, SHUFFLE, lane_schedule

if TYPE_CHECKING:
    from gymnasium_tpu_torch.physics.planar import PlanarWorld

__all__ = [
    "ChunkTerrain",
    "Heightfield",
    "PlanarTables",
    "planar_tables",
    "make_substep",
    "run_twin",
    "generate_planar_source",
]

_MAX_ANG_CORR = 8.0 * 3.14159265 / 180.0  # b2_maxAngularCorrection


@dataclasses.dataclass(frozen=True)
class ChunkTerrain:
    """``chunks`` heights ``spacing`` apart, linear between (LunarLander).

    Read as the JAX row program reads it: the index from the reciprocal
    multiply ``px * (1.0 / spacing)`` clipped to ``chunks - 1 - 1e-6``, the
    segment's two heights by an unrolled select over the index from values
    loaded once a call."""

    chunks: int
    spacing: float

    def inputs(self, ops) -> list:
        """The program's terrain inputs over ``SymOps``: one value a chunk."""
        return [ops.input(f"h{i}", varying=False) for i in range(self.chunks)]

    def rows(self, terrain) -> list:
        """The terrain inputs of an ``(N, chunks)`` tensor for ``TorchOps``."""
        return list(terrain.T.contiguous())

    def ground(self, ops, rows):
        """``px -> ground height`` over the terrain inputs ``rows``."""
        chunks, clip_top = self.chunks, self.chunks - 1 - 1e-6

        def height(px):
            xc = ops.clip(px * (1.0 / self.spacing), 0.0, clip_top)
            i0 = ops.floor(xc)
            h0, h1 = rows[0], rows[1]
            for i in range(1, chunks - 1):
                sel = i0 >= i
                h0 = ops.where(sel, rows[i], h0)
                h1 = ops.where(sel, rows[min(i + 1, chunks - 1)], h1)
            slope = h1 - h0
            return h0 + (xc - i0) * slope

        return height


@dataclasses.dataclass(frozen=True)
class Heightfield:
    """``chunks`` heights ``spacing`` apart, linear between (BipedalWalker's
    ``ground_height_fn``).

    Read by index, as the env computes it: ``xc = clip(px / spacing, 0,
    chunks - 1 - 1e-6)``, ``i0 = floor(xc)``, two loads from the env's row
    (the second at ``min(i0 + 1, chunks - 1)``) and ``h0 + (h1 - h0) * (xc
    - i0)``. The row stays in global memory."""

    chunks: int
    spacing: float

    def inputs(self, ops):
        """The program's terrain input over ``SymOps``: the env's row."""
        return ops.row("terrain")

    def rows(self, terrain):
        """The terrain input of an ``(N, chunks)`` tensor for ``TorchOps``."""
        return terrain

    def ground(self, ops, row):
        """``px -> ground height`` over the env's ``row``."""
        last, clip_top = self.chunks - 1, self.chunks - 1 - 1e-6

        def height(px):
            xc = ops.clip(ops.div(px, self.spacing), 0.0, clip_top)
            i0 = ops.floor(xc)
            frac = xc - i0
            h0 = ops.load(row, i0)
            h1 = ops.load(row, ops.minimum(i0 + 1.0, last))
            return h0 + (h1 - h0) * frac

        return height


@dataclasses.dataclass(frozen=True)
class PlanarTables:
    """The static constants of one world and its terrain, as python floats,
    and what the env gives the solver."""

    nbody: int
    njoint: int
    ncontact: int
    terrain: ChunkTerrain | Heightfield | None  # None: the ground is a callable of the caller
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
    motor_speed: list | None  # None: an input of each env
    motor_torque: list | None
    carry_joints: bool  # joint impulses warm-start the tick and are written out
    external: bool  # external force rows are inputs
    joint_clamp: float  # metres of joint point error pulled an iteration; 0: all of it
    baumgarte: float
    slop: float
    max_corr: float

    @property
    def chunks(self) -> int:
        return self.terrain.chunks

    @property
    def spacing(self) -> float:
        return self.terrain.spacing


def planar_tables(
    world: PlanarWorld,
    terrain: ChunkTerrain | Heightfield | None,
    motors=None,
    substeps: int = 2,
    carry_joints: bool = True,
    external: bool = True,
) -> PlanarTables:
    """Fold the world's tables into python floats, as the JAX generator does.

    ``motors`` is ``(motor_speed, motor_torque)``, one value a joint, folded
    into the program as constants, or None to make them inputs of each env.
    """
    if substeps < 1:
        raise ValueError(f"substeps must be at least 1, got {substeps}")
    if terrain is not None and terrain.chunks < 2:
        raise ValueError(f"the terrain needs at least 2 chunks, got {terrain.chunks}")
    anchor_a = np.asarray(world.joints.anchor_a, np.float64)
    anchor_b = np.asarray(world.joints.anchor_b, np.float64)
    c_point = np.asarray(world.contacts.point, np.float64)
    speed, torque = (None, None) if motors is None else motors
    return PlanarTables(
        nbody=len(world.bodies.inv_mass),
        njoint=len(world.joints.body_a),
        ncontact=len(world.contacts.body),
        terrain=terrain,
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
        motor_speed=None if speed is None else [float(v) for v in np.asarray(speed)],
        motor_torque=None if torque is None else [float(v) for v in np.asarray(torque)],
        carry_joints=bool(carry_joints),
        external=bool(external),
        joint_clamp=float(world.joint_correction_clamp),
        baumgarte=float(world.baumgarte),
        slop=float(world.contact_slop),
        max_corr=float(world.max_correction),
    )


def make_substep(t: PlanarTables, ops):
    """One solver tick ``(body, ext, ground, jimp, cimp, motor_speed,
    motor_torque) -> (body', jimp', cimp', flags)`` over lists of per-env
    values: ``body`` [B][6], ``ext`` [B][3] or None (no external force),
    ``ground`` a callable ``px -> ground height`` (``t.terrain.ground``, or
    any function of the backend's values), ``jimp`` [J][5] or None (the
    tick starts from zero joint impulses and ``jimp'`` is None), ``cimp``
    [C][2], and the motors' [J] speeds and torques (python floats or per-env
    values). The flags are the pre-step ``depth > 0`` of each contact. The
    solver iterations run through ``ops.repeat``, each angle's sine and
    cosine through ``ops.sincos``."""
    B, J, C = t.nbody, t.njoint, t.ncontact
    dt, g, inv_m, inv_i = t.dt, t.gravity, t.inv_m, t.inv_i
    j_a, j_b = t.j_a, t.j_b

    def substep(body, ext, ground, jimp, cimp, ms, mt):
        carry_joints = jimp is not None
        x = [body[b][0] for b in range(B)]
        y = [body[b][1] for b in range(B)]
        ang = [body[b][2] for b in range(B)]
        vx = [body[b][3] for b in range(B)]
        vy = [body[b][4] for b in range(B)]
        w = [body[b][5] for b in range(B)]

        # --- integrate gravity + external forces ------------------------------
        for b in range(B):
            with ops.unit("body", b):
                if inv_m[b] > 0:
                    vy[b] = vy[b] + g * dt
                    if ext is not None:
                        vx[b] = vx[b] + ext[b][0] * (inv_m[b] * dt)
                        vy[b] = vy[b] + ext[b][1] * (inv_m[b] * dt)
                        w[b] = w[b] + ext[b][2] * (inv_i[b] * dt)

        sin, cos = [None] * B, [None] * B
        for b in range(B):
            with ops.unit("body", b):
                sin[b], cos[b] = ops.sincos(ang[b])

        # joint anchor arms (pre-step pose)
        arms = []
        for j in range(J):
            with ops.unit("joint", j):
                a, b = j_a[j], j_b[j]
                ax, ay = t.anchor_a[j]
                bx, by = t.anchor_b[j]
                rax = ax * cos[a] - ay * sin[a]
                ray = ax * sin[a] + ay * cos[a]
                rbx = bx * cos[b] - by * sin[b]
                rby = bx * sin[b] + by * cos[b]
                arms.append((a, b, rax, ray, rbx, rby))

        # contact probes: world arm, depth
        cdata = []
        for k in range(C):
            with ops.unit("probe", k):
                b = t.c_body[k]
                px_, py_ = t.c_point[k]
                rx = px_ * cos[b] - py_ * sin[b]
                ry = px_ * sin[b] + py_ * cos[b]
                wx = x[b] + rx
                wy = y[b] + ry
                depth = ground(wx) - wy
                cdata.append((b, rx, ry, depth))
        flags = []
        for k in range(C):
            with ops.unit("probe", k):
                flags.append(cdata[k][3] > 0.0)

        # --- warm starting (Box2D b2Island::initVelocityConstraints) ----------
        if carry_joints:
            acc_m = [jimp[j][0] for j in range(J)]
            acc_lo = [jimp[j][1] for j in range(J)]
            acc_up = [jimp[j][2] for j in range(J)]
            acc_jx = [jimp[j][3] for j in range(J)]
            acc_jy = [jimp[j][4] for j in range(J)]
            for j in range(J):
                with ops.unit("joint", j):
                    a, b, rax, ray, rbx, rby = arms[j]
                    ang_l = acc_m[j] + acc_lo[j] + acc_up[j]
                    px_, py_ = acc_jx[j], acc_jy[j]
                    vx[a] = vx[a] - px_ * inv_m[a]
                    vy[a] = vy[a] - py_ * inv_m[a]
                    vx[b] = vx[b] + px_ * inv_m[b]
                    vy[b] = vy[b] + py_ * inv_m[b]
                    w[a] = w[a] - ((rax * py_ - ray * px_) + ang_l) * inv_i[a]
                    w[b] = w[b] + ((rbx * py_ - rby * px_) + ang_l) * inv_i[b]
        else:
            # the point impulses only feed the output: with none written
            # out they are not accumulated
            acc_m, acc_lo, acc_up, acc_jx, acc_jy = [0.0] * J, [0.0] * J, [0.0] * J, [], []
        acc_n = [None] * C
        acc_t = [None] * C
        for k in range(C):
            with ops.unit("probe", k):
                b, rx, ry, depth = cdata[k]
                live = depth > 0.0
                jn = ops.where(live, cimp[k][0], 0.0)
                jt = ops.where(live, cimp[k][1], 0.0)
                acc_n[k], acc_t[k] = jn, jt
                vx[b] = vx[b] + jt * inv_m[b]
                vy[b] = vy[b] + jn * inv_m[b]
                w[b] = w[b] + (rx * jn - ry * jt) * inv_i[b]

        # --- velocity iterations ------------------------------------------------
        nj = J if carry_joints else 0
        widths = (B, B, B, J, J, J, nj, nj, C, C)
        bodies = [("body", b) for b in range(B)]
        joints = [("joint", j) for j in range(J)]
        probes = [("probe", k) for k in range(C)]

        def velocity_iteration(carried):
            vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(carried, widths)
            for j in range(J):
                with ops.unit("joint", j):
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
                    if carry_joints:
                        acc_jx[j] = acc_jx[j] + ix
                        acc_jy[j] = acc_jy[j] + iy
                    vx[a] = vx[a] - ix * inv_m[a]
                    vy[a] = vy[a] - iy * inv_m[a]
                    vx[b] = vx[b] + ix * inv_m[b]
                    vy[b] = vy[b] + iy * inv_m[b]
                    w[a] = w[a] - (rax * iy - ray * ix) * inv_i[a]
                    w[b] = w[b] + (rbx * iy - rby * ix) * inv_i[b]

            for k in range(C):
                with ops.unit("probe", k):
                    b, rx, ry, depth = cdata[k]
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
            homes=3 * bodies + 3 * joints + (2 * joints if carry_joints else []) + 2 * probes,
        )
        vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(carried, widths)

        # --- integrate positions -------------------------------------------------
        for b in range(B):
            with ops.unit("body", b):
                x[b] = x[b] + vx[b] * dt
                y[b] = y[b] + vy[b] * dt
                ang[b] = ang[b] + w[b] * dt

        # --- position pass (contacts first, then joints) ------------------------
        def position_iteration(carried):
            x, y, ang = _split(carried, (B, B, B))
            for k in range(C):
                with ops.unit("probe", k):
                    b = t.c_body[k]
                    px_, py_ = t.c_point[k]
                    sb, cb = ops.sincos(ang[b])
                    rx = px_ * cb - py_ * sb
                    ry = px_ * sb + py_ * cb
                    wx = x[b] + rx
                    wy = y[b] + ry
                    depth = ground(wx) - wy
                    corr = ops.clip(t.baumgarte * (depth - t.slop), 0.0, t.max_corr)
                    k_n = ops.maximum(inv_m[b] + inv_i[b] * rx * rx, 1e-9)
                    lam = corr / k_n
                    y[b] = y[b] + lam * inv_m[b]
                    ang[b] = ang[b] + rx * lam * inv_i[b]

            for j in range(J):
                with ops.unit("joint", j):
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
                    if t.joint_clamp > 0.0:
                        # Box2D-style bounded sub-pull: at most joint_clamp metres
                        # of anchor error an iteration
                        err_len = ops.sqrt(errx * errx + erry * erry)
                        scale = ops.minimum(1.0, ops.div(t.joint_clamp, ops.maximum(err_len, 1e-9)))
                        errx = errx * scale
                        erry = erry * scale
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

        carried = ops.repeat(t.position_iterations, x + y + ang, position_iteration, homes=3 * bodies)
        x, y, ang = _split(carried, (B, B, B))

        body_out = [[x[b], y[b], ang[b], vx[b], vy[b], w[b]] for b in range(B)]
        jimp_out = None
        if carry_joints:
            jimp_out = [[acc_m[j], acc_lo[j], acc_up[j], acc_jx[j], acc_jy[j]] for j in range(J)]
        cimp_out = [[acc_n[k], acc_t[k]] for k in range(C)]
        return body_out, jimp_out, cimp_out, flags

    return substep


def run_twin(t: PlanarTables, ops: TorchOps, ground, bodies, external, jimp, cimp, motor_speed, motor_torque):
    """``t.substeps`` ticks of the program over ``TorchOps`` on batched
    tensors: ``bodies`` (N, B, 6), ``external`` (N, B, 3) or None, ``jimp``
    (N, J, 5) or None, ``cimp`` (N, C, 2), and ``(N, J)`` motors where
    ``t`` folds none; ``ground`` maps ``(N,)`` x to ground heights. Returns
    ``(bodies', jimp' or None, cimp', flags (N, C) bool)`` in float32."""
    substep = make_substep(t, ops)

    def columns(x, rows):
        """``rows`` lists of the (N,) float32 columns of ``x`` (N, rows, w)."""
        if x is None:
            return None
        x = x.to(torch.float32)
        return [list(x[:, r].T.contiguous()) for r in range(rows)]

    body = columns(bodies, t.nbody)
    ext = columns(external, t.nbody)
    jrows = columns(jimp, t.njoint)
    crows = columns(cimp, t.ncontact)
    ms, mt = t.motor_speed, t.motor_torque
    if ms is None:
        ms = list(motor_speed.to(torch.float32).T.contiguous())
        mt = list(motor_torque.to(torch.float32).T.contiguous())
    flags = None
    for _ in range(t.substeps):
        body, jrows, crows, flags = substep(body, ext, ground, jrows, crows, ms, mt)
    n = bodies.shape[0]

    def stack(rows, width):
        if rows is None:
            return None
        if not rows:
            return torch.zeros((n, 0, width), dtype=torch.float32, device=bodies.device)
        return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)

    return stack(body, 6), stack(jrows, 5), stack(crows, 2), torch.stack(flags, dim=1)


def _split(values, sizes):
    """``values`` cut into consecutive lists of the given sizes."""
    out, start = [], 0
    for size in sizes:
        out.append(list(values[start : start + size]))
        start += size
    return out


#: Lanes a group may give one env: the generator estimates each and keeps
#: the fastest (:func:`lane_estimates`).
LANE_CHOICES = (1, 2, 4, 8, 16)
_SCHEDULERS = 132 * 4  # warp schedulers of an H100
# warps a scheduler interleaves before their issue, not their latency, sets
# the time: on an H100 the walker's build at 16 lanes an env (four warps a
# scheduler at 4096 envs) took twice its time at 8 (two), whose warps run
# the same statements (tools/port_planar_probe.py lanes)
_HIDDEN_WARPS = 2
_CHOICE_ENVS = 4096  # the batch the choice is made for
_ALL = -1  # the home of a value every lane holds


@dataclasses.dataclass
class _Program:
    """One traced tick: the tables, the nodes and what the emitters read."""

    t: PlanarTables
    ops: SymOps
    outputs: list  # the new state (bodies, joint impulses, contact impulses), then the flags
    state: list  # the state inputs, in the order of the outputs
    homes: list  # (unit tag, field) of each state input
    live: list


def _trace(t: PlanarTables) -> _Program:
    B, J, C = t.nbody, t.njoint, t.ncontact
    ops = SymOps()
    ext = None
    if t.external:
        ext = [[ops.input(f"e{3 * b + i}", varying=False) for i in range(3)] for b in range(B)]
    ground = t.terrain.ground(ops, t.terrain.inputs(ops))
    body = [[ops.input(f"s{6 * b + i}", varying=True) for i in range(6)] for b in range(B)]
    homes = [(("body", b), i) for b in range(B) for i in range(6)]
    jimp = None
    if t.carry_joints:
        jimp = [[ops.input(f"j{5 * j + i}", varying=True) for i in range(5)] for j in range(J)]
        homes += [(("joint", j), i) for j in range(J) for i in range(5)]
    cimp = [[ops.input(f"k{2 * k + i}", varying=True) for i in range(2)] for k in range(C)]
    homes += [(("probe", k), i) for k in range(C) for i in range(2)]
    ms, mt = t.motor_speed, t.motor_torque
    if ms is None:
        ms = [ops.input(f"m{j}", varying=False) for j in range(J)]
        mt = [ops.input(f"m{J + j}", varying=False) for j in range(J)]
    body_out, jimp_out, cimp_out, flags = make_substep(t, ops)(body, ext, ground, jimp, cimp, ms, mt)
    state_out = [v for row in body_out + (jimp_out or []) + cimp_out for v in row]
    outputs = [x if isinstance(x, Sym) else ops.const(x) for x in state_out + flags]
    state = [v for row in body + (jimp or []) + cimp for v in row]
    return _Program(t, ops, outputs, state, homes, _live(outputs))


def lane_map(t: PlanarTables) -> dict:
    """The lane of each unit of the world's program: body ``b`` on lane
    ``b`` with its contact probes, and each joint on the lane of one of its
    bodies, joints that may run side by side (no body in common with a
    joint between them in the solver's order) on different lanes."""
    lane_of = {("body", b): b for b in range(t.nbody)}
    lane_of.update({("probe", k): t.c_body[k] for k in range(t.ncontact)})
    level = []
    for j in range(t.njoint):
        bodies = {t.j_a[j], t.j_b[j]}
        level.append(1 + max((level[i] for i in range(j) if bodies & {t.j_a[i], t.j_b[i]}), default=-1))
        taken = {lane_of[("joint", i)] for i in range(j) if level[i] == level[j]}
        free = [lane for lane in (t.j_a[j], t.j_b[j], *range(t.nbody)) if lane not in taken]
        lane_of[("joint", j)] = free[0] if free else t.j_a[j]
    return lane_of


class _LaneEmitter:
    """C lines of a traced tick laid over ``lanes`` lanes, one env a group.

    With one lane it writes plain C, each scope's statements in the order
    the program made them: the one-thread form. With more, every lane runs
    the same statements (the ``PL_`` macros of
    ``csrc/planar_step.cuh``): a phase's units share a shape, and what
    differs between lanes is an operand, a per-lane constant (``K``/``P``/
    ``I`` tables computed once a call) or a value read from another lane
    (``PL_SHFL``). A value's home is the lane (or every lane) that holds it
    and its name there. A lane that runs no unit of a phase computes
    don't-care values that no later statement reads; the heightfield's
    clipped index keeps its loads inside the row whatever they are.
    ``cost`` is the schedule's clocks of one tick (:data:`LATENCY`,
    :data:`SHUFFLE`, :data:`SELECT`, each statement times its loop's trips).
    """

    def __init__(self, prog: _Program, lanes: int, lane_of: dict):
        self.prog, self.ops, self.G, self.lane_of = prog, prog.ops, lanes, lane_of
        self.one = lanes == 1
        self.homes = collections.defaultdict(dict)
        self.tables: dict = {}
        self.table_lines: list = []
        self.names: set = set()
        self.trips = 1
        self.cost = self.shuffles = self.selects = self.phases = self.temps = 0
        # what the text does, in order: ("phase", block, {lane: (unit, nodes)}),
        # ("loop", carried nodes) at a loop's start, ("end", its results) after it
        self.trace: list = []
        self.blocks = 0
        self.slot_of: dict = {}
        for tag, lane in lane_of.items():
            self.slot_of[tag] = sum(1 for u in self.slot_of if u[0] == tag[0] and lane_of[u] == lane)

    def v(self, name: str) -> str:
        """A lane's value of ``name``."""
        return name if self.one else f"PL_V({name})"

    def let(self, ctype: str, name: str, expr: str) -> str:
        return f"const {ctype} {name} = {expr};" if self.one else f"PL_LET({ctype}, {name}, {expr});"

    def var(self, ctype: str, name: str, expr: str) -> str:
        return f"{ctype} {name} = {expr};" if self.one else f"PL_VAR({ctype}, {name}, {expr});"

    def assign(self, name: str, expr: str) -> str:
        return f"{name} = {expr};" if self.one else f"PL_SET({name}, {expr});"

    def fresh(self, base: str) -> str:
        name, k = base, 0
        while name in self.names:
            k += 1
            name = f"{base}_{k}"
        self.names.add(name)
        return name

    def table(self, ctype: str, values) -> str:
        """``PL_V(name)`` of a per-lane constant: ``values[lane]``."""
        key = (ctype, tuple(values))
        if key not in self.tables:
            name = self.tables[key] = f"{ {'float': 'K', 'bool': 'P', 'int': 'I'}[ctype]}{len(self.tables)}"
            distinct = sorted(set(values), key=values.index)
            expr = distinct[-1]
            for v in reversed(distinct[:-1]):
                cond = " || ".join(f"PL_LANE == {r}" for r in range(self.G) if values[r] == v)
                expr = f"({cond}) ? {v} : {expr}"
            self.table_lines.append(f"PL_LET({ctype}, {name}, {expr});")
        return f"PL_V({self.tables[key]})"

    def operand(self, by_lane: dict, ctype: str, pre: list, cache: dict) -> str:
        """The C text of an operand whose node differs by lane (``by_lane``:
        lane -> node, the lanes that run a unit); reads from other lanes go
        into ``pre`` as shuffles, made once a phase (``cache``)."""
        groups: dict = {}
        lits, names = {}, {}
        for r, n in by_lane.items():
            if n.kind == "const":
                lits[r] = _literal(n.value)
                continue
            h = self.homes.get(n.id)
            if not h:
                raise ValueError(f"no lane holds t{n.id} where lane {r} reads it")
            if _ALL in h:
                groups.setdefault(h[_ALL], set()).add(r)
            else:
                src = r if r in h else min(h)
                names.setdefault(h[src], {})[r] = src
        if lits:
            values = set(lits.values())
            text = values.pop() if len(values) == 1 else self.table(
                ctype, [lits.get(r, next(iter(lits.values()))) for r in range(self.G)])
            groups.setdefault(text, set()).update(lits)
        for name, srcs in names.items():
            if all(src == r for r, src in srcs.items()):
                text = self.v(name)
            else:
                key = (name, tuple(srcs.get(r, r) for r in range(self.G)))
                if key not in cache:
                    tmp = cache[key] = f"x{self.temps}"
                    self.temps += 1
                    pre.append(f"PL_LET({ctype}, {tmp}, PL_SHFL({name}, {self.table('int', list(key[1]))}));")
                    self.shuffles += self.trips
                    self.cost += SHUFFLE * self.trips
                text = f"PL_V({cache[key]})"
            groups.setdefault(text, set()).update(srcs)
        ordered = sorted(groups.items(), key=lambda kv: (-len(kv[1]), kv[0]))
        text = ordered[0][0]
        for other, lanes in ordered[1:]:
            pick = self.table("bool", ["true" if r in lanes else "false" for r in range(self.G)])
            text = f"{pick} ? {other} : {text}"
            self.selects += self.trips
            self.cost += SELECT * self.trips
        return f"({text})" if len(ordered) > 1 else text

    def phase(self, units: dict, nodes: dict, ind: str) -> list:
        """The statements of one phase: ``units`` lane -> tag, ``nodes`` tag
        -> its statement nodes; the lowest lane's unit is the template."""
        lists = {r: nodes[tag] for r, tag in units.items()}
        self.trace.append(("phase", self.blocks, {r: (units[r], lists[r]) for r in lists}))
        template = lists[min(lists)]
        lines, cache = [], {}
        for i, tn in enumerate(template):
            name = self.fresh(f"t{tn.id}")
            pre: list = []
            args = [self.operand({r: lst[i].args[a] for r, lst in lists.items()}, _ctype(tn.args[a]), pre, cache)
                    for a in range(len(tn.args))]
            if tn.kind == "sincos" and self.one:
                statement = f"float {name}s, {name}c; sincosf({args[0]}, &{name}s, &{name}c);"
            elif tn.kind == "sincos":
                statement = f"PL_SINCOS({name}, {args[0]});"
            else:
                statement = self.let(_ctype(tn), name, _expression(tn, args))
            lines += [ind + line for line in pre + [statement]]
            self.cost += LATENCY[tn.kind] * self.trips
            for r, lst in lists.items():
                self.homes[lst[i].id][r] = name
                if tn.kind == "sincos":
                    for part, suffix in ((0, "s"), (1, "c")):
                        node = self.ops._memo.get(("part", lst[i].id, part))
                        if node is not None:
                            self.homes[node.id][r] = name + suffix
        self.phases += 1
        return lines

    def block(self, nodes: list, ind: str) -> list:
        """The phases of one straight-line block of statement nodes; with
        one lane, one phase of them all in the program's order."""
        if not nodes:
            return []
        if self.one:
            lines = self.phase({0: ("block", self.blocks)}, {("block", self.blocks): nodes}, ind)
            self.blocks += 1
            return lines
        ids = {n.id for n in nodes}
        units = {}
        for tag, requested in self.ops.requests.items():
            mine = [n for n in requested.values() if n.id in ids]
            if mine:
                units[tag] = mine
        stray = ids - {n.id for mine in units.values() for n in mine}
        if stray:
            raise ValueError(f"statements {sorted(stray)[:5]} belong to no unit: the program cannot be laid over lanes")
        lines = []
        for units_of_phase in lane_schedule(units, {u: self.lane_of[u[0]] for u in units}):
            lines += self.phase(units_of_phase, units, ind)
        self.blocks += 1
        return lines

    def keys(self, tags) -> dict:
        """``{key: {lane: index}}`` of values owned by ``tags`` (``(tag,
        field)`` pairs): a key is the same register on every lane; with one
        lane, each value its own."""
        if self.one:
            return {i: {0: i} for i in range(len(tags))}
        out: dict = {}
        for i, (tag, field) in enumerate(tags):
            key = (tag[0], self.slot_of[tag], field)
            lanes = out.setdefault(key, {})
            if self.lane_of[tag] in lanes:
                raise ValueError(f"two values of key {key} on lane {self.lane_of[tag]}")
            lanes[self.lane_of[tag]] = i
        return out

    def scope(self, nodes: list, ind: str) -> list:
        """Live nodes of one scope, in creation order: blocks between loops."""
        lines, block = [], []
        for n in nodes:
            if n.kind == "loop":
                lines += self.block(block, ind) + self.loop(n, ind)
                block = []
            else:
                block.append(n)
        return lines + self.block(block, ind)

    def loop(self, node, ind: str) -> list:
        loop, inner = node.value, ind + "  "
        k = len(loop.carries)
        inits, outs = node.args[:k], node.args[k:]
        if loop.homes is None and not self.one:
            raise ValueError("a loop laid over lanes needs the unit that owns each carried value")
        homes = loop.homes or [None] * k
        fields = [(tag, sum(1 for h in homes[:i] if h == tag)) for i, tag in enumerate(homes)]
        keys = self.keys(fields)
        lines, regs = [], {}
        for key, lanes in keys.items():
            first = lanes[min(lanes)]
            ct = _ctype(loop.carries[first])
            name = regs[key] = self.fresh(f"c{loop.carries[first].id}")
            pre: list = []
            init = self.operand({r: inits[i] for r, i in lanes.items()}, ct, pre, {})
            lines += [ind + line for line in pre + [self.var(ct, name, init)]]
            for r, i in lanes.items():
                self.homes[loop.carries[i].id][r] = name
        lines += [ind + "PLANAR_NO_UNROLL", f"{ind}for (int it = 0; it < {loop.n}; ++it) {{"]
        self.trace.append(("loop", list(loop.carries)))
        outer_trips, self.trips = self.trips, self.trips * loop.n
        lines += self.scope([n for n in self.prog.live if n.scope is loop], inner)
        updates, cache = [], {}
        for key, lanes in keys.items():
            ct = _ctype(loop.carries[lanes[min(lanes)]])
            pre = []
            value = self.operand({r: outs[i] for r, i in lanes.items()}, ct, pre, cache)
            lines += [inner + line for line in pre + [self.let(ct, f"n{regs[key]}", value)]]
            updates.append(inner + self.assign(regs[key], self.v(f"n{regs[key]}")))
        self.trips = outer_trips
        lines += updates + [f"{ind}}}"]
        results = []
        for key, lanes in keys.items():
            for r, i in lanes.items():
                out = self.ops._memo.get(("loopout", node.id, i))
                if out is not None:
                    self.homes[out.id][r] = regs[key]
                    results.append(out)
        self.trace.append(("end", results))
        return lines

    def run_lines(self, ind2: str) -> list:
        """The body of ``run``: the tick's state in per-lane registers, the
        substep loop, and the stores of each lane's share."""
        prog, t = self.prog, self.prog.t
        ind3 = ind2 + "  "
        for n in prog.ops.nodes:
            if n.kind == "input" and not n.varying:
                self.homes[n.id][_ALL] = n.value
        prologue = [n for n in prog.live if n.scope is None and not n.varying]
        for n in prologue:
            self.homes[n.id][_ALL] = f"t{n.id}"
            self.names.add(f"t{n.id}")
        lines = emit(prologue, prog.live, ind2, "PLANAR_NO_UNROLL")
        # one thread writes its rows back in place; lanes store their share
        outs = {"body": "body_out", "jimp": "jimp_out", "cimp": "cimp_out", "flags": "flags_out"}

        def store(src, index, lanes, name):
            if self.one:
                return f"{ind2}{src}[{index[0]}] = {name};"
            mine = "true" if len(lanes) == self.G else self.table(
                "bool", ["true" if r in lanes else "false" for r in range(self.G)])
            return f"{ind2}PL_STORE({mine}, {outs[src]}[{self.table('int', index)}], PL_V({name}));"

        sources = {"s": "body", "j": "jimp", "k": "cimp"}
        keys = self.keys(prog.homes)
        state, stores = {}, []
        for key, lanes in keys.items():
            first = prog.state[lanes[min(lanes)]].value
            src = sources[first[0]]
            index = [prog.state[lanes.get(r, lanes[min(lanes)])].value[1:] for r in range(self.G)]
            name = state[key] = self.fresh(first)
            at = index[0] if self.one else self.table("int", index)
            lines.append(ind2 + self.var("float", name, f"{src}[{at}]"))
            for r, i in lanes.items():
                self.homes[prog.state[i].id][r] = name
            stores.append(store(src, index, lanes, name))
        flag_keys = self.keys([(("probe", k), "flag") for k in range(t.ncontact)])
        flags = {}
        for key, lanes in flag_keys.items():
            name = flags[key] = self.fresh(f"f{lanes[min(lanes)]}")
            lines.append(ind2 + self.var("bool", name, "false"))
            stores.append(store("flags", [str(lanes.get(r, lanes[min(lanes)])) for r in range(self.G)], lanes, name))
        lines += [f"{ind2}PLANAR_NO_UNROLL", f"{ind2}for (int sub = 0; sub < {t.substeps}; ++sub) {{"]
        lines += self.scope([n for n in prog.live if n.scope is None and n.varying], ind3)
        n_state = len(prog.state)
        updates, cache = [], {}
        for key, lanes in keys.items():
            pre: list = []
            value = self.operand({r: prog.outputs[i] for r, i in lanes.items()}, "float", pre, cache)
            lines += [ind3 + line for line in pre + [self.let("float", f"n{state[key]}", value)]]
            updates.append(ind3 + self.assign(state[key], self.v(f"n{state[key]}")))
        for key, lanes in flag_keys.items():
            pre = []
            value = self.operand({r: prog.outputs[n_state + i] for r, i in lanes.items()}, "bool", pre, cache)
            lines += [ind3 + line for line in pre]
            updates.append(ind3 + self.assign(flags[key], value))
        lines += updates + [f"{ind2}}}"] + stores
        return [ind2 + line for line in self.table_lines] + lines


def _occupancy(lanes: int, envs: int = _CHOICE_ENVS) -> float:
    """How much more than one warp's latency a call of ``envs`` envs takes,
    in the schedule's model: a scheduler hides the latency of up to
    :data:`_HIDDEN_WARPS` warps, beyond which their instructions queue."""
    warps = -(-envs * lanes // 32)
    return max(1.0, warps / _SCHEDULERS / _HIDDEN_WARPS)


def lane_estimates(prog: _Program) -> dict:
    """``{lanes: clocks}``: the schedule's estimate of one tick of one warp
    (``_LaneEmitter.cost``) for each lane count the world fits (one, or a
    lane a body), times :func:`_occupancy` at :data:`_CHOICE_ENVS` envs.

    The model is not validated beyond the two worlds it was checked on:
    :data:`_HIDDEN_WARPS` was fitted to one reading (the walker's build at 16
    lanes, on an H100), and its constants are that card's. On the walker and
    the lander it picks what the rule "the smallest power of two with a lane
    a body" gives; a new world's choice wants the probe's sweep
    (tools/port_planar_probe.py lanes) before it is trusted."""
    lane_of = lane_map(prog.t)
    out = {}
    for lanes in LANE_CHOICES:
        if lanes == 1 or lanes >= prog.t.nbody:
            emitter = _LaneEmitter(prog, lanes, lane_of)
            emitter.run_lines("")
            out[lanes] = emitter.cost * _occupancy(lanes)
    return out


def generate_planar_source(
    world: PlanarWorld,
    terrain: ChunkTerrain | Heightfield,
    motors,
    substeps: int,
    carry_joints: bool,
    external: bool,
    name: str,
    lanes: int | None = None,
    stage_terrain: bool | None = None,
) -> GeneratedSource:
    """Emit the kernel source of ``substeps`` solver ticks of ``world``
    (the arguments of :func:`planar_tables`).

    The text defines ``struct PlanarStep`` with the widths and a
    ``__host__ __device__`` ``run`` that steps one env, then instantiates the
    fixed kernel and entry points of ``csrc/planar_step.cuh``. ``terrain`` points at the
    env's row in global memory. A world whose env gives per-env motors,
    carries no joint impulses or applies no external force says so in the
    struct (``kMotors``, ``kJointCarry``, ``kExternal``), and its ``run``
    takes the motors as a seventh argument, speeds then torques. Under
    ``nvcc`` that gives the launcher ``planar_step_launch``; under a plain
    C++ compiler the host loop ``planar_step_host``.

    ``lanes`` lanes of a warp step each env (:class:`_LaneEmitter`; the
    struct declares ``kLanes``); by default the count of
    :data:`LANE_CHOICES` with the lowest :func:`lane_estimates`. With one
    lane ``run`` holds the whole env in one thread's registers. With more,
    lanes exchange values by ``__shfl_sync`` (an exchange through shared
    memory ran 3.5 % slower on an H100: tools/port_planar_probe.py lanes).
    ``stage_terrain`` has a group of lanes copy the env's heightfield into
    shared memory before the first tick; by default a heightfield is staged
    where there are several lanes, since the walker's build ran 0.7 % faster
    so at 8 lanes. The layout is in the source's ``layout``.
    """
    t = planar_tables(world, terrain, motors, substeps, carry_joints, external)
    B, J, C, chunks = t.nbody, t.njoint, t.ncontact, t.chunks
    prog = _trace(t)
    live = prog.live
    estimates = lane_estimates(prog)
    if lanes is None:
        lanes = min(estimates, key=lambda g: (estimates[g], g))
    if lanes not in estimates:
        raise ValueError(f"{name}: {lanes} lanes do not fit the world's {B} bodies (one a lane); "
                         f"choices {sorted(estimates)}")
    if stage_terrain is None:
        stage_terrain = lanes > 1 and isinstance(t.terrain, Heightfield)
    if stage_terrain and (lanes == 1 or not isinstance(t.terrain, Heightfield)):
        raise ValueError("only a group of lanes stages a row, and only a heightfield row")
    outer = [n for n in live if n.scope is None]
    prologue = [n for n in outer if not n.varying]
    loop = [n for n in outer if n.varying]
    inner = [n for n in live if n.scope is not None]
    prologue_ops = op_counts(prologue)
    substep_ops = op_counts(loop + inner)

    def counts(c):
        return ", ".join(f"{k} {v}" for k, v in sorted(c.items()))

    per_env_motors = t.motor_speed is None
    # the lander's form declares no parts and takes six arguments
    lander_form = t.external and t.carry_joints and not per_env_motors and lanes == 1
    ind2 = " " * 4
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/planar_codegen.py for {name},",
        f"// substeps {substeps}. Do not edit: edit the generator.",
        f"// Once a call: {counts(prologue_ops) or 'nothing'}.",
        f"// Each substep: {counts(substep_ops)}.",
    ]
    emitter = _LaneEmitter(prog, lanes, lane_map(t))
    body = emitter.run_lines(ind2)
    layout = {"lanes": lanes, "stage_terrain": stage_terrain,
              "estimates": {g: round(v) for g, v in estimates.items()}, "phases": emitter.phases,
              "shuffles": emitter.shuffles, "selects": emitter.selects, "lane_tables": len(emitter.tables)}
    if lanes > 1:
        lines.append(f"// {lanes} lanes an env: {emitter.phases} phases, {emitter.shuffles} shuffles and "
                     f"{emitter.selects} selects a tick; estimate {round(emitter.cost)} clocks a tick.")
    lines += [
        '#include "planar_step.cuh"',
        "",
        "struct PlanarStep {",
        f"  static constexpr int kBodies = {B};",
        f"  static constexpr int kJoints = {J};",
        f"  static constexpr int kContacts = {C};",
        f"  static constexpr int kChunks = {chunks};",
    ]
    if lander_form:
        lines += [
            "  static PLANAR_FN void run(float* body, const float* ext, const float* terrain,",
            "                            float* jimp, float* cimp, bool* flags) {",
        ]
    else:
        lines += [
            f"  static constexpr bool kExternal = {str(t.external).lower()};",
            f"  static constexpr bool kJointCarry = {str(t.carry_joints).lower()};",
            f"  static constexpr bool kMotors = {str(per_env_motors).lower()};",
        ]
        if stage_terrain:
            lines.append("  static constexpr bool kStageTerrain = true;")
        if lanes > 1:
            lines += [
                f"  static constexpr int kLanes = {lanes};",
                "  static PLANAR_FN void run(const float* body, const float* ext, const float* terrain,",
                "                            const float* jimp, const float* cimp, const float* motor_speed,",
                "                            const float* motor_torque, float* body_out, float* jimp_out,",
                "                            float* cimp_out, bool* flags_out, int lane, bool store) {",
            ]
        else:
            lines += [
                "  static PLANAR_FN void run(float* body, const float* ext, const float* terrain,",
                "                            float* jimp, float* cimp, bool* flags, const float* motors) {",
            ]
    if t.external:
        lines += [f"{ind2}const float e{i} = ext[{i}];" for i in range(3 * B)]
    if isinstance(t.terrain, ChunkTerrain):
        lines += [f"{ind2}const float h{i} = terrain[{i}];" for i in range(chunks)]
    if per_env_motors and lanes > 1:
        lines += [f"{ind2}const float m{i} = motor_speed[{i}];" for i in range(J)]
        lines += [f"{ind2}const float m{J + i} = motor_torque[{i}];" for i in range(J)]
    elif per_env_motors:
        lines += [f"{ind2}const float m{i} = motors[{i}];" for i in range(2 * J)]
    lines += body + ["  }", "};", "", "PLANAR_ENTRY_POINTS(PlanarStep)", ""]
    return GeneratedSource(name, substeps, "\n".join(lines), prologue_ops, substep_ops, layout)
