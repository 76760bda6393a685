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
"""

from __future__ import annotations

import dataclasses

import numpy as np

from typing import TYPE_CHECKING

import torch

from gymnasium_tpu_torch.ops.codegen import (
    GeneratedSource,
    Sym,
    SymOps,
    TorchOps,
    _live,
    _ref,
    emit,
    op_counts,
)

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
            if inv_m[b] > 0:
                vy[b] = vy[b] + g * dt
                if ext is not None:
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

        # contact probes: world arm, depth
        cdata = []
        for k in range(C):
            b = t.c_body[k]
            px_, py_ = t.c_point[k]
            rx = px_ * cos[b] - py_ * sin[b]
            ry = px_ * sin[b] + py_ * cos[b]
            wx = x[b] + rx
            wy = y[b] + ry
            depth = ground(wx) - wy
            cdata.append((b, rx, ry, depth))
        flags = [cd[3] > 0.0 for cd in cdata]

        # --- warm starting (Box2D b2Island::initVelocityConstraints) ----------
        if carry_joints:
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
        else:
            # the point impulses only feed the output: with none written
            # out they are not accumulated
            acc_m, acc_lo, acc_up, acc_jx, acc_jy = [0.0] * J, [0.0] * J, [0.0] * J, [], []
        acc_n = [None] * C
        acc_t = [None] * C
        for k in range(C):
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

        def velocity_iteration(carried):
            vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(carried, widths)
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
        )
        vx, vy, w, acc_m, acc_lo, acc_up, acc_jx, acc_jy, acc_n, acc_t = _split(carried, widths)

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
                depth = ground(wx) - wy
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

        carried = ops.repeat(t.position_iterations, x + y + ang, position_iteration)
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


def generate_planar_source(
    world: PlanarWorld,
    terrain: ChunkTerrain | Heightfield,
    motors,
    substeps: int,
    carry_joints: bool,
    external: bool,
    name: str,
) -> GeneratedSource:
    """Emit the kernel source of ``substeps`` solver ticks of ``world``
    (the arguments of :func:`planar_tables`).

    The text defines ``struct PlanarStep`` with the widths and a
    ``__host__ __device__`` ``run(body, ext, terrain, jimp, cimp, flags)``
    that steps one env in registers, then instantiates the fixed kernel and
    entry points of ``csrc/planar_step.cuh``. ``terrain`` points at the
    env's row in global memory. A world whose env gives per-env motors,
    carries no joint impulses or applies no external force says so in the
    struct (``kMotors``, ``kJointCarry``, ``kExternal``), and its ``run``
    takes the motors as a seventh argument, speeds then torques. Under
    ``nvcc`` that gives the launcher ``planar_step_launch``; under a plain
    C++ compiler the host loop ``planar_step_host``.
    """
    t = planar_tables(world, terrain, motors, substeps, carry_joints, external)
    B, J, C, chunks = t.nbody, t.njoint, t.ncontact, t.chunks
    ops = SymOps()
    ext = None
    if t.external:
        ext = [[ops.input(f"e{3 * b + i}", varying=False) for i in range(3)] for b in range(B)]
    ground = t.terrain.ground(ops, t.terrain.inputs(ops))
    body = [[ops.input(f"s{6 * b + i}", varying=True) for i in range(6)] for b in range(B)]
    jimp = None
    if t.carry_joints:
        jimp = [[ops.input(f"j{5 * j + i}", varying=True) for i in range(5)] for j in range(J)]
    cimp = [[ops.input(f"k{2 * k + i}", varying=True) for i in range(2)] for k in range(C)]
    ms, mt = t.motor_speed, t.motor_torque
    per_env_motors = ms is None
    if per_env_motors:
        ms = [ops.input(f"m{j}", varying=False) for j in range(J)]
        mt = [ops.input(f"m{J + j}", varying=False) for j in range(J)]
    body_out, jimp_out, cimp_out, flags = make_substep(t, ops)(body, ext, ground, jimp, cimp, ms, mt)
    state_out = [v for row in body_out + (jimp_out or []) + cimp_out for v in row]
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

    n_body, n_jimp, n_cimp = 6 * B, 5 * J if t.carry_joints else 0, 2 * C
    state = (
        [f"s{i}" for i in range(n_body)]
        + [f"j{i}" for i in range(n_jimp)]
        + [f"k{i}" for i in range(n_cimp)]
    )
    # the lander's form declares no parts and takes six arguments
    lander_form = t.external and t.carry_joints and not per_env_motors
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
            "  static PLANAR_FN void run(float* body, const float* ext, const float* terrain,",
            "                            float* jimp, float* cimp, bool* flags, const float* motors) {",
        ]
    if t.external:
        lines += [f"{ind2}const float e{i} = ext[{i}];" for i in range(3 * B)]
    if isinstance(t.terrain, ChunkTerrain):
        lines += [f"{ind2}const float h{i} = terrain[{i}];" for i in range(chunks)]
    if per_env_motors:
        lines += [f"{ind2}const float m{i} = motors[{i}];" for i in range(2 * J)]
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
