"""Generator of the articulated (MuJoCo-class) substep, over two backends.

Counterpart of the generator inside the JAX package's
``ops/pallas_articulated.py::make_fused_step``. From the static tables of an
:class:`~gymnasium_tpu_torch.physics.articulated.ArticulatedModel` it unrolls
one substep of the engine as straight-line scalar code: forward kinematics
with the free-root quaternion, world inertias, geometric Jacobians, the
closed-form convective terms, the Newton-Euler bias with gravity and springs,
joint limits, soft contacts with a friction cone, the sparse symbolic mass
matrix, a dense symbolic Cholesky solve, and semi-implicit Euler with the
quaternion exponential.

Sparsity is folded in Python as the JAX generator folds it: a python float
``0.0`` is a structural zero, and constants combine in float64 until they
meet a per-env value, where they round to float32 once. The generator is
written once, over the ops namespace of :mod:`gymnasium_tpu_torch.ops.codegen`,
and runs over its two backends: over ``TorchOps`` it computes the substep
itself (the plain PyTorch twin); over ``SymOps`` :func:`generate_source`
emits the live nodes as one C statement each, which gives the CUDA source of
the kernel and the count of each kind of operation it holds.

Both backends run the JAX row program's operations in its order, with the
same rounded constants.

The same module emits the contact-wrench kernel (:func:`generate_wrench_source`):
the substep's forward kinematics and its contact forces (one function,
:func:`contact_force`, for both programs), summed into each body's
``[torque, force]`` (:func:`wrench_program`); and the centre-of-mass kernels
(:func:`generate_com_source`): over the same forward kinematics, each body's
centre-of-mass velocity (:func:`com_velocity_program`) and the whole
robot's mass centre along x (:func:`mass_center_x_program`).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import json
import os
from pathlib import Path

import numpy as np

from gymnasium_tpu_torch.ops.codegen import (
    GeneratedSource,
    Sym,
    SymOps,
    _ctype,
    _expression,
    _live,
    _ref,
    _statement,
)
from gymnasium_tpu_torch.ops import warp_partition
from gymnasium_tpu_torch.ops.build import BUILD_DIR
from gymnasium_tpu_torch.ops.warp_partition import (
    SHARED_BYTES_MAX,
    layout_clocks,
    partition,
    sincos_pairs,
)
from gymnasium_tpu_torch.physics.articulated import (
    HINGE,
    SLIDE,
    ArticulatedModel,
    ancestor_dof_mask,
    contact_constants,
    is_free_root_body,
    limit_constants,
    q_index,
    quat_to_mat_np,
    strict_dof_ancestors,
)

__all__ = [
    "ModelTables",
    "model_tables",
    "forward_kinematics",
    "kinematics_and_bias",
    "contact_force",
    "make_substep",
    "clip_controls",
    "GeneratedSource",
    "generate_source",
    "substep_program",
    "choose_layout",
    "layout_candidates",
    "wrench_program",
    "generate_wrench_source",
    "com_velocity_program",
    "mass_center_x_program",
    "generate_com_source",
]

#: The layout of a robot's kernel is the one the layout model
#: (``warp_partition.layout_clocks``) gives the fewest clocks at this many
#: envs, the batch of the vector envs and of the PPO step, among one thread
#: an env and ``G`` warps a group of 32 envs for each ``G`` of
#: :data:`PART_CHOICES`, with as many groups a block as the card's limits
#: allow.
LAYOUT_ENVS = 4096
PART_CHOICES = (4, 8, 16)
MAX_WARPS_BLOCK = 32
MAX_NAMED_GROUPS = 15  # named barriers 1..15, one a group
#: Layouts within this share of the fewest clocks tie, and the tie goes to
#: the fewest warps a group, then the fewest groups a block: the fitted
#: model does not rank layouts this close as the card does (Walker2d's 4 x 2
#: ran 6 % faster than its 8 x 2, 0.6 % apart in the model; PERF.md).
LAYOUT_TIE = 0.01
#: Where each choice of :func:`kept_choice` is kept, beside the kernels'
#: builds: choosing takes seconds for a Humanoid, and every process that
#: steps one would choose again before it finds its built kernel.
CHOICE_DIR = BUILD_DIR / "layouts"

# ---------------------------------------------------------------------------
# Folding helpers: a python float 0.0 is a structural zero, 1.0 a unit.


def _nonzero(x) -> bool:
    return not (isinstance(x, float) and x == 0.0)


def _add(a, b):
    if not _nonzero(a):
        return b
    if not _nonzero(b):
        return a
    return a + b


def _sub(a, b):
    if not _nonzero(b):
        return a
    if not _nonzero(a):
        return -b
    return a - b


def _mul(a, b):
    if not _nonzero(a) or not _nonzero(b):
        return 0.0
    if isinstance(a, float) and a == 1.0:
        return b
    if isinstance(b, float) and b == 1.0:
        return a
    return a * b


def _dot3(u, v):
    return _add(_add(_mul(u[0], v[0]), _mul(u[1], v[1])), _mul(u[2], v[2]))


def _cross(u, v):
    return [
        _sub(_mul(u[1], v[2]), _mul(u[2], v[1])),
        _sub(_mul(u[2], v[0]), _mul(u[0], v[2])),
        _sub(_mul(u[0], v[1]), _mul(u[1], v[0])),
    ]


def _matvec(A, v):
    return [_dot3(A[i], v) for i in range(3)]


def _matmul(A, B):
    return [
        [
            _add(_add(_mul(A[i][0], B[0][j]), _mul(A[i][1], B[1][j])), _mul(A[i][2], B[2][j]))
            for j in range(3)
        ]
        for i in range(3)
    ]


def _scale(v, s):
    return [_mul(x, s) for x in v]


def _vadd(u, v):
    return [_add(u[i], v[i]) for i in range(3)]


def _vsub(u, v):
    return [_sub(u[i], v[i]) for i in range(3)]


# ---------------------------------------------------------------------------
# Model constants, as python floats.


@dataclasses.dataclass(frozen=True)
class ModelTables:
    """The static constants of one model, in python floats and numpy masks."""

    model: ArticulatedModel
    nv: int
    nq: int
    nu: int
    nbody: int
    nc: int
    dt: float
    amask: np.ndarray  # (nbody, nv) dof k moves body b
    strict: np.ndarray  # (nv, nv) dof j applied before dof k
    strict_rot: np.ndarray  # strict, with the free root's rotations coupled
    jtypes: list
    masses: list
    coms: list
    inertias: list
    damping: list
    armature: list
    stiffness: list
    joint_ref: list
    gear: list
    act_dof: list
    ctrl_lo: list
    ctrl_hi: list
    gravity: float
    limit_k: list
    limit_c: list
    contact_k: list
    contact_c: list
    contact_r: list
    contact_off: list
    contact_body: list
    cmask: np.ndarray  # (nc, nv) dof k moves contact ci


def model_tables(model: ArticulatedModel) -> ModelTables:
    """Fold the model's tables into the generator's constants (float64)."""
    nv, nu = model.nv, model.nu
    nc = len(model.contact_body)
    dt = float(model.timestep)
    amask = ancestor_dof_mask(model)
    strict = strict_dof_ancestors(model)
    strict_rot = strict.copy()
    if model.root_free:
        strict_rot[3:6, 3:6] = True
    gear = [float(g) for g in model.act_gear]
    act_dof = [int(d) for d in model.act_dof]
    armature = [float(a) for a in model.joints.armature]
    masses = [float(m) for m in model.bodies.mass]

    limit_k, limit_c = limit_constants(model)
    contact_k, contact_c = contact_constants(model)
    cmask = amask[np.asarray(model.contact_body)] if nc else np.zeros((0, nv), dtype=bool)

    return ModelTables(
        model=model,
        nv=nv,
        nq=model.nq,
        nu=nu,
        nbody=len(model.bodies.parent),
        nc=nc,
        dt=dt,
        amask=amask,
        strict=strict,
        strict_rot=strict_rot,
        jtypes=[int(t) for t in model.joints.jtype],
        masses=masses,
        coms=[[float(x) for x in c] for c in model.bodies.com],
        inertias=[np.asarray(I, np.float64) for I in model.bodies.inertia],
        damping=[float(d) for d in model.joints.damping],
        armature=armature,
        stiffness=[float(s) for s in model.joints.stiffness],
        joint_ref=[float(r) for r in model.joints.ref],
        gear=gear,
        act_dof=act_dof,
        ctrl_lo=[float(v) for v in model.act_ctrlrange[:, 0]] if nu else [],
        ctrl_hi=[float(v) for v in model.act_ctrlrange[:, 1]] if nu else [],
        gravity=float(model.gravity),
        limit_k=[float(v) for v in limit_k],
        limit_c=[float(v) for v in limit_c],
        contact_k=[float(v) for v in contact_k],
        contact_c=[float(v) for v in contact_c],
        contact_r=[float(v) for v in model.contact_radius],
        contact_off=[[float(x) for x in o] for o in model.contact_pos],
        contact_body=[int(b) for b in model.contact_body],
        cmask=cmask,
    )


# ---------------------------------------------------------------------------
# The substep program, over an ops namespace.


def clip_controls(t: ModelTables, ops, crows):
    """Clip each actuator's control row to its ctrlrange."""
    return [ops.clip(crows[a], t.ctrl_lo[a], t.ctrl_hi[a]) for a in range(t.nu)]


def forward_kinematics(t: ModelTables, ops, qrows):
    """The substep's forward kinematics over lists of per-env values:
    ``(Rs, ps, axes_w, pivots_w)``, the bodies' rotations and origins and
    each dof's world axis and pivot where the dof is applied."""
    model = t.model
    nv, nbody = t.nv, t.nbody
    jtypes, joint_ref = t.jtypes, t.joint_ref

    Rs, ps = [None] * nbody, [None] * nbody
    axes_w, pivots_w = [None] * nv, [None] * nv
    for b in range(nbody):
        parent = int(model.bodies.parent[b])
        if parent < 0:
            R_p = [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]]
            p_p = [0.0, 0.0, 0.0]
        else:
            R_p, p_p = Rs[parent], ps[parent]

        if is_free_root_body(model, b):
            w, x, y, z = qrows[3], qrows[4], qrows[5], qrows[6]
            nn = w * w + x * x + y * y + z * z
            s2 = 2.0 / ops.maximum(nn, 1e-12)
            R = [
                [1 - s2 * (y * y + z * z), s2 * (x * y - w * z), s2 * (x * z + w * y)],
                [s2 * (x * y + w * z), 1 - s2 * (x * x + z * z), s2 * (y * z - w * x)],
                [s2 * (x * z - w * y), s2 * (y * z + w * x), 1 - s2 * (x * x + y * y)],
            ]
            p = [qrows[0], qrows[1], qrows[2]]
            start = int(model.bodies.dof_start[b])
            for k in range(3):
                e = [0.0, 0.0, 0.0]
                e[k] = 1.0
                axes_w[start + k] = e
                pivots_w[start + k] = [0.0, 0.0, 0.0]
            for k in range(3):
                axes_w[start + 3 + k] = [R[0][k], R[1][k], R[2][k]]
                pivots_w[start + 3 + k] = p
            Rs[b], ps[b] = R, p
            continue

        Rfix = [[float(v) for v in row] for row in quat_to_mat_np(model.bodies.quat[b])]
        R = _matmul(R_p, Rfix)
        p = _vadd(p_p, _matvec(R_p, [float(v) for v in model.bodies.pos[b]]))
        start = int(model.bodies.dof_start[b])
        count = int(model.bodies.dof_count[b])
        for k in range(start, start + count):
            axis = [float(v) for v in model.joints.axis[k]]
            anchor = [float(v) for v in model.joints.anchor[k]]
            qk = qrows[q_index(model, k)]
            if joint_ref[k]:
                qk = _sub(qk, joint_ref[k])
            axes_w[k] = _matvec(R, axis)
            if jtypes[k] == SLIDE:
                pivots_w[k] = [0.0, 0.0, 0.0]
                p = _vadd(p, _matvec(R, _scale(axis, qk)))
            else:
                pivots_w[k] = _vadd(p, _matvec(R, anchor))
                c_, s_ = ops.cos(qk), ops.sin(qk)
                ax, ay, az = axis
                K = [[0.0, -az, ay], [az, 0.0, -ax], [-ay, ax, 0.0]]
                Rj = [
                    [
                        _add(
                            _add(_mul(c_, 1.0 if i == j else 0.0), _mul(s_, K[i][j])),
                            _mul(_sub(1.0, c_), axis[i] * axis[j]),
                        )
                        for j in range(3)
                    ]
                    for i in range(3)
                ]
                p = _vadd(p, _matvec(R, _vsub(anchor, _matvec(Rj, anchor))))
                R = _matmul(R, Rj)
        Rs[b], ps[b] = R, p
    return Rs, ps, axes_w, pivots_w


def kinematics_and_bias(t: ModelTables, ops, qrows, qdrows):
    """The substep's forward kinematics and Newton-Euler bias over lists of
    per-env values: ``(Rs, ps, axes_w, pivots_w, Iw, Jv, c_rows)``, the
    bodies' rotations and origins, each dof's world axis and pivot, the
    bodies' world inertias, their com Jacobians (``None`` where a dof does
    not move a body) and the bias ``c_rows`` (velocity terms, gravity and
    the joint springs) of each dof.
    """
    model = t.model
    nv, nbody = t.nv, t.nbody
    amask, strict, strict_rot, jtypes = t.amask, t.strict, t.strict_rot, t.jtypes
    masses, joint_ref = t.masses, t.joint_ref
    Rs, ps, axes_w, pivots_w = forward_kinematics(t, ops, qrows)

    # body com positions and world inertias R I Rᵀ
    pcs = [
        _vadd(ps[b], _matvec(Rs[b], t.coms[b])) if any(t.coms[b]) else ps[b]
        for b in range(nbody)
    ]
    Iw = []
    for b in range(nbody):
        I = t.inertias[b]
        RI = [
            [_dot3(Rs[b][i], [float(I[m][j]) for m in range(3)]) for j in range(3)]
            for i in range(3)
        ]
        Iw.append([[_dot3(RI[i], Rs[b][j]) for j in range(3)] for i in range(3)])

    # ---------------- geometric Jacobians -----------------------
    Jv = [[None] * nv for _ in range(nbody)]
    for b in range(nbody):
        for k in range(nv):
            if not amask[b, k]:
                continue
            if jtypes[k] == SLIDE:
                Jv[b][k] = axes_w[k]
            else:
                Jv[b][k] = _cross(axes_w[k], _vsub(pcs[b], pivots_w[k]))

    # ---------------- closed-form convective terms --------------
    u = [_scale(axes_w[k], qdrows[k]) if jtypes[k] == HINGE else None for k in range(nv)]
    s_vec = [_scale(axes_w[k], qdrows[k]) if jtypes[k] == SLIDE else None for k in range(nv)]
    daw = []
    for k in range(nv):
        w_pre = [0.0, 0.0, 0.0]
        for j in range(nv):
            if strict_rot[k, j] and u[j] is not None:
                w_pre = _vadd(w_pre, u[j])
        daw.append(_cross(w_pre, axes_w[k]))
    dow = []
    for k in range(nv):
        acc = [0.0, 0.0, 0.0]
        for j in range(nv):
            if not strict[k, j]:
                continue
            if s_vec[j] is not None:
                acc = _vadd(acc, s_vec[j])
            else:
                acc = _vadd(acc, _cross(u[j], _vsub(pivots_w[k], pivots_w[j])))
        dow.append(acc)
    dpc = []
    for b in range(nbody):
        acc = [0.0, 0.0, 0.0]
        for k in range(nv):
            if Jv[b][k] is not None:
                acc = _vadd(acc, _scale(Jv[b][k], qdrows[k]))
        dpc.append(acc)
    a0, al0 = [], []
    for b in range(nbody):
        acc = [0.0, 0.0, 0.0]
        accw = [0.0, 0.0, 0.0]
        for k in range(nv):
            if not amask[b, k]:
                continue
            if jtypes[k] == SLIDE:
                dJ = daw[k]
            else:
                dJ = _vadd(
                    _cross(daw[k], _vsub(pcs[b], pivots_w[k])),
                    _cross(axes_w[k], _vsub(dpc[b], dow[k])),
                )
                accw = _vadd(accw, _scale(daw[k], qdrows[k]))
            acc = _vadd(acc, _scale(dJ, qdrows[k]))
        a0.append(acc)
        al0.append(accw)

    # ---------------- bias (Newton-Euler + gravity/springs) -----
    wb = []
    for b in range(nbody):
        acc = [0.0, 0.0, 0.0]
        for k in range(nv):
            if amask[b, k] and u[k] is not None:
                acc = _vadd(acc, u[k])
        wb.append(acc)
    c_rows = [0.0] * nv
    for b in range(nbody):
        f_lin = _scale(a0[b], masses[b])
        Iww = _matvec(Iw[b], wb[b])
        t_ang = _vadd(_matvec(Iw[b], al0[b]), _cross(wb[b], Iww))
        for k in range(nv):
            if not amask[b, k]:
                continue
            c_rows[k] = _add(c_rows[k], _dot3(Jv[b][k], f_lin))
            if jtypes[k] == HINGE:
                c_rows[k] = _add(c_rows[k], _dot3(axes_w[k], t_ang))
    for k in range(nv):
        acc = 0.0
        for b in range(nbody):
            if amask[b, k]:
                acc = _add(acc, _mul(masses[b], Jv[b][k][2]))
        c_rows[k] = _sub(c_rows[k], _mul(t.gravity, acc))
        if t.stiffness[k]:
            qk = qrows[q_index(model, k)]
            c_rows[k] = _add(c_rows[k], _mul(t.stiffness[k], _sub(qk, joint_ref[k])))
    return Rs, ps, axes_w, pivots_w, Iw, Jv, c_rows


def contact_force(t: ModelTables, ops, ci: int, Rs, ps, axes_w, pivots_w, qdrows):
    """Contact sphere ``ci``'s soft contact with the ground: ``(pt, Jc_k,
    f)``, its centre in the world, its Jacobian row ``{dof: 3-vector}`` over
    the dofs that move it, and the world force on it, a penalty spring and
    damper along z with viscous friction clamped to the friction cone."""
    model = t.model
    b = t.contact_body[ci]
    pt = _vadd(ps[b], _matvec(Rs[b], t.contact_off[ci]))
    Jc_k = {}
    vel = [0.0, 0.0, 0.0]
    for k in range(t.nv):
        if not t.cmask[ci, k]:
            continue
        if t.jtypes[k] == SLIDE:
            Jck = axes_w[k]
        else:
            Jck = _cross(axes_w[k], _vsub(pt, pivots_w[k]))
        Jc_k[k] = Jck
        vel = _vadd(vel, _scale(Jck, qdrows[k]))
    depth = t.contact_r[ci] - (pt[2] - float(model.ground_z))
    in_contact = depth > 0.0
    fn = ops.maximum(
        ops.where(in_contact, t.contact_k[ci] * depth - t.contact_c[ci] * vel[2], 0.0),
        0.0,
    )
    ftx = _mul(-t.contact_c[ci], vel[0])
    fty = _mul(-t.contact_c[ci], vel[1])
    ft_norm = ops.sqrt(ftx * ftx + fty * fty + 1e-12)
    scale_f = ops.minimum(1.0, float(model.friction) * fn / ft_norm)
    return pt, Jc_k, [ftx * scale_f, fty * scale_f, fn]


def make_substep(t: ModelTables, ops, crows):
    """One substep ``(qrows, qdrows) -> (q_new, qd_new)`` over lists of
    per-env values, for the (already clipped) control rows ``crows``.

    The actuation torques are formed here, once, outside the substep.
    """
    model = t.model
    nv, nq, nbody, dt = t.nv, t.nq, t.nbody, t.dt
    amask, jtypes = t.amask, t.jtypes
    masses = t.masses

    tau_act = [0.0] * nv
    for a in range(t.nu):
        tau_act[t.act_dof[a]] = _add(tau_act[t.act_dof[a]], _mul(t.gear[a], crows[a]))

    def substep(qrows, qdrows):
        Rs, ps, axes_w, pivots_w, Iw, Jv, c_rows = kinematics_and_bias(t, ops, qrows, qdrows)

        # ---------------- torques: actuation + limits + contacts ----
        tau = list(tau_act)
        for k in range(nv):
            if not bool(model.joints.limited[k]):
                continue
            qk = qrows[q_index(model, k)]
            below = ops.minimum(qk - float(model.joints.lower[k]), 0.0)
            above = ops.maximum(qk - float(model.joints.upper[k]), 0.0)
            violating = (below < 0.0) | (above > 0.0)
            t_lim = -t.limit_k[k] * (below + above) - ops.where(
                violating, t.limit_c[k] * qdrows[k], 0.0
            )
            tau[k] = _add(tau[k], t_lim)

        for ci in range(t.nc):
            _, Jc_k, f = contact_force(t, ops, ci, Rs, ps, axes_w, pivots_w, qdrows)
            for k, Jck in Jc_k.items():
                tau[k] = _add(tau[k], _dot3(Jck, f))

        # ---------------- mass matrix (sparse symbolic) -------------
        M = {}
        for i in range(nv):
            for j in range(i, nv):
                acc = 0.0
                for b in range(nbody):
                    if not (amask[b, i] and amask[b, j]):
                        continue
                    acc = _add(acc, _mul(masses[b], _dot3(Jv[b][i], Jv[b][j])))
                    if jtypes[i] == HINGE and jtypes[j] == HINGE:
                        acc = _add(acc, _dot3(axes_w[i], _matvec(Iw[b], axes_w[j])))
                if i == j:
                    acc = _add(acc, t.armature[i] + dt * t.damping[i] + 1e-9)
                if _nonzero(acc):
                    M[(i, j)] = acc

        # ---------------- rhs + Cholesky solve ----------------------
        rhs = [_sub(_sub(tau[k], c_rows[k]), _mul(t.damping[k], qdrows[k])) for k in range(nv)]
        L = {}
        for j in range(nv):
            d = M.get((j, j), 0.0)
            for m in range(j):
                ljm = L.get((j, m), 0.0)
                d = _sub(d, _mul(ljm, ljm))
            d = ops.sqrt(ops.maximum(d, 1e-12))
            inv_d = 1.0 / d
            L[(j, j)] = d
            for i in range(j + 1, nv):
                v = M.get((j, i), 0.0) if j <= i else M.get((i, j), 0.0)
                for m in range(j):
                    v = _sub(v, _mul(L.get((i, m), 0.0), L.get((j, m), 0.0)))
                if _nonzero(v):
                    L[(i, j)] = _mul(v, inv_d)
        y = [0.0] * nv
        for i in range(nv):
            v = rhs[i]
            for m in range(i):
                v = _sub(v, _mul(L.get((i, m), 0.0), y[m]))
            y[i] = _mul(v, 1.0 / L[(i, i)])
        qacc = [0.0] * nv
        for i in reversed(range(nv)):
            v = y[i]
            for m in range(i + 1, nv):
                v = _sub(v, _mul(L.get((m, i), 0.0), qacc[m]))
            qacc[i] = _mul(v, 1.0 / L[(i, i)])

        # ---------------- integrate ---------------------------------
        qd_new = [qdrows[k] + dt * qacc[k] for k in range(nv)]
        if not model.root_free:
            return [qrows[k] + dt * qd_new[k] for k in range(nq)], qd_new
        pos_new = [qrows[i] + dt * qd_new[i] for i in range(3)]
        # quat <- quat ⊗ exp(dt ω/2); both branches are computed and selected
        vx, vy, vz = dt * qd_new[3], dt * qd_new[4], dt * qd_new[5]
        th2 = vx * vx + vy * vy + vz * vz
        big = th2 > 1e-10
        th = ops.sqrt(ops.where(big, th2, 1.0))
        half = 0.5 * th
        sinc = ops.where(big, ops.sin(half) / th, 0.5 - th2 / 48.0)
        cosh_ = ops.where(big, ops.cos(half), 1.0 - th2 / 8.0 + th2 * th2 / 384.0)
        dq = [cosh_, sinc * vx, sinc * vy, sinc * vz]
        a_, b_, c2, d_ = qrows[3], qrows[4], qrows[5], qrows[6]
        quat = [
            a_ * dq[0] - b_ * dq[1] - c2 * dq[2] - d_ * dq[3],
            a_ * dq[1] + b_ * dq[0] + c2 * dq[3] - d_ * dq[2],
            a_ * dq[2] - b_ * dq[3] + c2 * dq[0] + d_ * dq[1],
            a_ * dq[3] + b_ * dq[2] - c2 * dq[1] + d_ * dq[0],
        ]
        # x ** 2 of the JAX source lowers to x * x
        qnorm = ops.sqrt(
            quat[0] * quat[0] + quat[1] * quat[1] + quat[2] * quat[2] + quat[3] * quat[3] + 1e-24
        )
        quat = [x / qnorm for x in quat]
        joints_new = [qrows[7 + i] + dt * qd_new[6 + i] for i in range(nq - 7)]
        return pos_new + quat + joints_new, qd_new

    return substep


def substep_program(t: ModelTables):
    """One substep over symbolic nodes: ``(prologue, body, outputs)``.

    ``prologue`` are the live nodes that depend on the controls alone (run
    once a call), ``body`` the live nodes of the substep in creation order,
    ``outputs`` the new ``q`` then ``qd`` values (nodes, constants included).
    """
    ops = SymOps()
    crows = [ops.input(f"c{a}", varying=False) for a in range(t.nu)]
    qrows = [ops.input(f"q{i}", varying=True) for i in range(t.nq)]
    qdrows = [ops.input(f"v{i}", varying=True) for i in range(t.nv)]
    substep = make_substep(t, ops, clip_controls(t, ops, crows))
    q_new, qd_new = substep(qrows, qdrows)
    outputs = [x if isinstance(x, Sym) else ops.const(x) for x in q_new + qd_new]
    live = _live(outputs)
    return [n for n in live if not n.varying], [n for n in live if n.varying], outputs


def layout_candidates(t: ModelTables, body) -> dict:
    """Every layout the rule weighs, ``(parts, groups) -> WarpPartition``:
    one thread an env (``(1, 4)``: 128 threads a block) and ``parts`` warps
    a group with ``groups`` groups a block, within the card's limits (warps
    a block, named barriers, shared memory a block), each ``parts`` with
    the partition :func:`~gymnasium_tpu_torch.ops.warp_partition.partition`
    gives."""
    carried = t.nq + t.nv
    out = {(1, 4): partition(body, 1, carried)}
    for parts in PART_CHOICES:
        wp = partition(body, parts, carried)
        for groups in range(1, min(MAX_WARPS_BLOCK // parts, MAX_NAMED_GROUPS) + 1):
            if wp.shared_bytes(groups) > SHARED_BYTES_MAX:
                break
            out[(parts, groups)] = wp
    return out


def choose_layout(t: ModelTables, body, frame_skip: int) -> tuple[tuple, object, dict]:
    """The layout with the fewest clocks in the layout model at
    :data:`LAYOUT_ENVS` envs, the smallest of those within
    :data:`LAYOUT_TIE` of it: ``((parts, groups), WarpPartition, {layout:
    clocks})``."""
    candidates = layout_candidates(t, body)
    clocks = {key: layout_clocks(wp, key[1], LAYOUT_ENVS, frame_skip)["clocks"] for key, wp in candidates.items()}
    least = min(clocks.values())
    best = min(key for key, c in clocks.items() if c <= least * (1 + LAYOUT_TIE))
    return best, candidates[best], clocks


def kept_choice(t: ModelTables, body, frame_skip: int) -> tuple[tuple, object, dict]:
    """:func:`choose_layout`'s answer, read from :data:`CHOICE_DIR` when an
    earlier call kept it (then without its ``WarpPartition``: None), else
    chosen and kept. The key is a digest of the substep program, the widths,
    ``frame_skip`` and the code that chooses (this module and
    ``warp_partition``), so any change to one of them chooses again."""
    digest = hashlib.sha256(f"{frame_skip} {t.nq} {t.nv}\n".encode())
    digest.update("\n".join(_statement(n) for n in body).encode())
    for module in (__file__, warp_partition.__file__):
        digest.update(Path(module).read_bytes())
    path = CHOICE_DIR / f"{digest.hexdigest()[:24]}.json"
    try:
        kept = json.loads(path.read_text())
        return tuple(kept["layout"]), None, {tuple(key): c for key, c in kept["clocks"]}
    except (OSError, ValueError, KeyError, TypeError):
        pass
    best, wp, clocks = choose_layout(t, body, frame_skip)
    path.parent.mkdir(parents=True, exist_ok=True)
    partial = path.with_name(f"{path.name}.{os.getpid()}")  # written whole, then renamed
    partial.write_text(json.dumps({"layout": best, "clocks": [[list(key), c] for key, c in clocks.items()]}))
    os.replace(partial, path)
    return best, wp, clocks


def generate_source(
    model: ArticulatedModel, frame_skip: int, name: str, parts: int | None = None, groups: int | None = None
) -> GeneratedSource:
    """Emit the kernel source of ``frame_skip`` substeps of ``model``.

    The text defines ``struct ArticulatedStep`` with the model's widths and a
    ``__host__ __device__`` ``run`` that steps one env, then instantiates the
    fixed kernel and entry points of ``csrc/articulated_step.cuh``. Under
    ``nvcc`` that gives the launcher ``articulated_step_launch``; under a
    plain C++ compiler the host loop ``articulated_step_host``, which tests
    the same text without a card.

    ``parts`` warps share each group of 32 envs and ``groups`` groups share
    a block (1 by default); with no ``parts`` the layout is
    :func:`choose_layout`'s (:func:`kept_choice`). With one part,
    ``run(q, qd, ctrl)`` holds the whole step in one thread's registers.
    With more, the substep's operations are partitioned over the warps
    (:func:`~gymnasium_tpu_torch.ops.warp_partition.partition`) and
    ``run<part>(q, qd, ctrl, x)`` is one partition, exchanging values
    through the group's shared memory ``x`` between phases.
    """
    if frame_skip < 1:
        raise ValueError(f"frame_skip must be at least 1, got {frame_skip}")
    t = model_tables(model)
    prologue, body, outputs = substep_program(t)
    estimates = None
    if parts is None:
        (parts, groups), wp, clocks = kept_choice(t, body, frame_skip)
        estimates = {"g{}x{}".format(*key): round(c) for key, c in sorted(clocks.items(), key=lambda kv: kv[1])}
    else:
        groups = 1 if groups is None else groups
        wp = None
    if parts < 1 or groups < 1 or parts * groups > MAX_WARPS_BLOCK or groups > MAX_NAMED_GROUPS:
        raise ValueError(f"{parts} warps a group and {groups} groups a block do not fit a block")
    prologue_ops = dict(collections.Counter(n.kind for n in prologue))
    substep_ops = dict(collections.Counter(n.kind for n in body))

    def counts(c):
        return ", ".join(f"{k} {v}" for k, v in sorted(c.items()))

    if parts > 1:
        if wp is None:
            wp = partition(body, parts, t.nq + t.nv)
        if wp.shared_bytes(groups) > SHARED_BYTES_MAX:
            raise ValueError(f"{name} on {parts} warps needs {wp.shared_bytes(groups)} B of shared memory a "
                             f"block of {groups} groups, more than {SHARED_BYTES_MAX}")
        lines = _partitioned_lines(t, frame_skip, name, counts(prologue_ops), counts(substep_ops),
                                   prologue, outputs, wp, groups)
        layout = {
            "parts": parts,
            "env_groups": groups,
            "phases": wp.phases,
            "exchanged": wp.exchanged,
            "exchange_loads": wp.exchange_loads,
            "recomputed_ops": len(wp.recomputed),
            "shared_bytes_per_block": wp.shared_bytes(groups),
        }
        if estimates is not None:
            layout["estimates"] = estimates
        return GeneratedSource(name, frame_skip, "\n".join(lines), prologue_ops, substep_ops, layout)

    ind2, ind3 = " " * 4, " " * 6
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/articulated_codegen.py for {name},",
        f"// frame_skip {frame_skip}. Do not edit: edit the generator.",
        f"// Once a call: {counts(prologue_ops) or 'nothing'}.",
        f"// Each substep: {counts(substep_ops)}.",
        '#include "articulated_step.cuh"',
        "",
        "struct ArticulatedStep {",
        f"  static constexpr int kNq = {t.nq};",
        f"  static constexpr int kNv = {t.nv};",
        f"  static constexpr int kNu = {t.nu};",
        "  static ART_FN void run(float* q, float* qd, const float* ctrl) {",
    ]
    lines += [f"{ind2}const float c{a} = ctrl[{a}];" for a in range(t.nu)]
    lines += [ind2 + _statement(n) for n in prologue]
    lines += [f"{ind2}float q{i} = q[{i}];" for i in range(t.nq)]
    lines += [f"{ind2}float v{i} = qd[{i}];" for i in range(t.nv)]
    lines += [f"{ind2}ART_NO_UNROLL", f"{ind2}for (int s = 0; s < {frame_skip}; ++s) {{"]
    lines += [ind3 + _statement(n) for n in body]
    new = [f"q{i}" for i in range(t.nq)] + [f"v{i}" for i in range(t.nv)]
    lines += [f"{ind3}const float n{var} = {_ref(o)};" for var, o in zip(new, outputs)]
    lines += [f"{ind3}{var} = n{var};" for var in new]
    lines += [f"{ind2}}}"]
    lines += [f"{ind2}q[{i}] = q{i};" for i in range(t.nq)]
    lines += [f"{ind2}qd[{i}] = v{i};" for i in range(t.nv)]
    lines += ["  }", "};", "", "ART_ENTRY_POINTS(ArticulatedStep)", ""]
    layout = {"parts": 1, "env_groups": 4, "phases": 1, "exchanged": 0, "exchange_loads": 0,
              "recomputed_ops": 0, "shared_bytes_per_block": 0}
    if estimates is not None:
        layout["estimates"] = estimates
    return GeneratedSource(name, frame_skip, "\n".join(lines), prologue_ops, substep_ops, layout)


def _partitioned_lines(t, frame_skip, name, prologue_counts, substep_counts, prologue, outputs, wp, groups):
    """The text of a step whose substep runs on ``wp.parts`` warps.

    ``run<kPart>`` holds, inside the ``frame_skip`` loop, every phase's block
    of every partition, each guarded by ``ART_PART(p)``: on the card a warp
    instantiates its own partition, and the other blocks fold away; on the
    host ``run<-1>`` runs each phase's partitions in order for one env.
    Every body value is declared at the top of a substep and assigned where
    its partition computes or loads it. After the last phase each new
    ``q``/``qd`` value is stored by its owner to slots ``0 .. kNq + kNv - 1``,
    and after the barrier every partition reads them back.
    """
    ind2, ind3, ind4 = " " * 4, " " * 6, " " * 8
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/articulated_codegen.py for {name},",
        f"// frame_skip {frame_skip}. Do not edit: edit the generator.",
        f"// Once a call: {prologue_counts or 'nothing'}.",
        f"// Each substep: {substep_counts}.",
        f"// Partitioned over {wp.parts} warps in {wp.phases} phases: {wp.exchanged} values exchanged "
        f"({wp.exchange_loads} loads), {len(wp.recomputed)} operations recomputed, {wp.slots} slots an env.",
        '#include "articulated_step.cuh"',
        "",
        "struct ArticulatedStep {",
        f"  static constexpr int kNq = {t.nq};",
        f"  static constexpr int kNv = {t.nv};",
        f"  static constexpr int kNu = {t.nu};",
        f"  static constexpr int kParts = {wp.parts};",
        f"  static constexpr int kGroups = {groups};",
        f"  static constexpr int kSlots = {wp.slots};",
        "  template <int kPart, typename X>",
        "  static ART_FN void run(const float* q, const float* qd, const float* ctrl, X& x) {",
    ]
    lines += [f"{ind2}const float c{a} = ctrl[{a}];" for a in range(t.nu)]
    lines += [ind2 + _statement(n) for n in prologue]
    lines += [f"{ind2}float q{i} = q[{i}];" for i in range(t.nq)]
    lines += [f"{ind2}float v{i} = qd[{i}];" for i in range(t.nv)]
    lines += [f"{ind2}ART_NO_UNROLL", f"{ind2}for (int s = 0; s < {frame_skip}; ++s) {{"]
    body = sorted({n.id: n for phase in wp.blocks for block in phase for n in block}.values(), key=lambda n: n.id)
    for ctype in ("float", "bool"):
        names = [f"t{n.id}" for n in body if _ctype(n) == ctype]
        lines += [f"{ind3}{ctype} {', '.join(names[i:i + 16])};" for i in range(0, len(names), 16)]

    def load(n, slot):
        return f"t{n.id} = x[{slot}] != 0.0f;" if n.dtype == "b" else f"t{n.id} = x[{slot}];"

    def store(n, slot):
        return f"x[{slot}] = t{n.id} ? 1.0f : 0.0f;" if n.dtype == "b" else f"x[{slot}] = t{n.id};"

    def statements(nodes):
        """One assignment a node; the sine and cosine of one angle from one
        call of ``art::sin_cos`` (a ``sincosf``, out of line on the card)."""
        pairs = {n.id: (s, c) for s, c in sincos_pairs(nodes) for n in (s, c)}
        out = []
        for n in nodes:
            if n.id not in pairs:
                out.append(f"t{n.id} = {_expression(n)};")
            elif n is min(pairs[n.id], key=lambda m: m.id):
                s, c = pairs[n.id]
                out.append(f"{{ const art::SinCos sc = art::sin_cos({_ref(n.args[0])}); "
                           f"t{s.id} = sc.s; t{c.id} = sc.c; }}")
        return out

    for k in range(wp.phases):
        if k:
            lines.append(f"{ind3}x.sync();")
        for p in range(wp.parts):
            block = ([load(n, s) for n, s in wp.loads[k][p]]
                     + statements(wp.blocks[k][p])
                     + [store(n, s) for n, s in wp.stores[k][p]])
            if block:
                lines += [f"{ind3}if (ART_PART({p})) {{"] + [ind4 + s for s in block] + [f"{ind3}}}"]
    if wp.phases == 1:  # the carried stores must follow the previous substep's reads
        lines.append(f"{ind3}x.sync();")
    new = [f"q{i}" for i in range(t.nq)] + [f"v{i}" for i in range(t.nv)]
    for p in range(wp.parts):
        owned = [f"x[{i}] = {_ref(o)};" for i, o in enumerate(outputs) if wp.owner.get(o.id, 0) == p]
        if owned:
            lines += [f"{ind3}if (ART_PART({p})) {{"] + [ind4 + s for s in owned] + [f"{ind3}}}"]
    lines.append(f"{ind3}x.sync();")
    lines += [f"{ind3}{var} = x[{i}];" for i, var in enumerate(new)]
    lines += [f"{ind2}}}", "  }", "};", "", "ART_PARTS_ENTRY_POINTS(ArticulatedStep)", ""]
    return lines


# ---------------------------------------------------------------------------
# The contact wrenches: forward kinematics and the substep's contact forces.

#: Threads (envs) a block of the wrench and centre-of-mass kernels; a kernel
#: that stages rows takes as many as fit them in :data:`WRENCH_SHARED_MAX`
#: bytes of static shared memory, halved from this.
WRENCH_BLOCK = 128
WRENCH_SHARED_MAX = 48 * 1024


def wrench_program(t: ModelTables, ops, qrows, qdrows) -> list:
    """Each body's external contact wrench ``[torque, force]`` about its com
    (MuJoCo's ``cfrc_ext`` without the world row) over lists of per-env
    values: ``nbody * 6`` values, body by body, a python ``0.0`` for a body
    with no contact sphere. Each contact's force is the substep's own
    (:func:`contact_force`); a body sums ``[lever x f, f]`` over its contacts
    in their order, the lever from its com ``ps[b] + Rs[b] com_b``."""
    Rs, ps, axes_w, pivots_w = forward_kinematics(t, ops, qrows)
    wrench = [[0.0] * 6 for _ in range(t.nbody)]
    coms = {}
    for ci in range(t.nc):
        b = t.contact_body[ci]
        pt, _, f = contact_force(t, ops, ci, Rs, ps, axes_w, pivots_w, qdrows)
        if b not in coms:
            coms[b] = _vadd(ps[b], _matvec(Rs[b], t.coms[b]))
        torque = _cross(_vsub(pt, coms[b]), f)
        wrench[b] = [_add(w, x) for w, x in zip(wrench[b], torque + f)]
    return [x for row in wrench for x in row]


def _staged_rows(name: str, row: int, what: str) -> tuple[int, int]:
    """``(stride, block)`` of a kernel that stages each env's ``row`` floats
    through shared memory: an odd stride, so a warp's stores of one value
    hit 32 banks, and as many threads a block as fit their rows in
    :data:`WRENCH_SHARED_MAX` bytes, halved from :data:`WRENCH_BLOCK`."""
    stride = row | 1
    block = WRENCH_BLOCK
    while block > 32 and 4 * block * stride > WRENCH_SHARED_MAX:
        block //= 2
    if 4 * block * stride > WRENCH_SHARED_MAX:
        raise ValueError(f"{name}'s {what} need {4 * block * stride} B of shared memory a block")
    return stride, block


def _straight_lines(live, ind: str) -> list[str]:
    """One C statement per live node, the sine and cosine of one angle from
    one ``sincosf``."""
    pairs = {n.id: (s, c) for s, c in sincos_pairs(live) for n in (s, c)}
    lines = []
    for n in live:
        if n.id not in pairs:
            lines.append(ind + _statement(n))
        elif n is min(pairs[n.id], key=lambda m: m.id):
            s, c = pairs[n.id]
            lines.append(f"{ind}float t{s.id}, t{c.id}; sincosf({_ref(n.args[0])}, &t{s.id}, &t{c.id});")
    return lines


def _counts(live) -> dict:
    return dict(collections.Counter(n.kind for n in live))


def _listed(counts: dict) -> str:
    return ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))


def generate_wrench_source(model: ArticulatedModel, name: str) -> GeneratedSource:
    """Emit the contact-wrench kernel source of ``model``.

    The text defines ``struct ContactWrenches`` with the model's widths, the
    block size and a ``__host__ __device__`` ``run(q, qd, w)`` that computes
    one env's ``nbody * 6`` wrench values from its ``q`` and ``qd`` rows in
    registers, one C statement per live operation of :func:`wrench_program`
    (the sine and cosine of one angle from one ``sincosf``), and writes them
    to ``w``. It then instantiates the fixed kernel and entry points of
    ``csrc/contact_wrenches.cuh``: under ``nvcc`` the launcher
    ``contact_wrenches_launch``, under a plain C++ compiler the host loop
    ``contact_wrenches_host``.
    """
    t = model_tables(model)
    if t.nc == 0:
        raise ValueError(f"{name} has no contact sphere: its wrenches are zeros, with no kernel")
    ops = SymOps()
    qrows = [ops.input(f"q{i}", varying=True) for i in range(t.nq)]
    qdrows = [ops.input(f"v{i}", varying=True) for i in range(t.nv)]
    outputs = [x if isinstance(x, Sym) else ops.const(x) for x in wrench_program(t, ops, qrows, qdrows)]
    live = _live(outputs)
    row = 6 * t.nbody
    stride, block = _staged_rows(name, row, f"{t.nbody} bodies")
    ops_counts = _counts(live)
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/articulated_codegen.py for {name}: the",
        "// contact wrenches. Do not edit: edit the generator.",
        f"// Each call: {_listed(ops_counts)}.",
        '#include "contact_wrenches.cuh"',
        "",
        "struct ContactWrenches {",
        f"  static constexpr int kNq = {t.nq};",
        f"  static constexpr int kNv = {t.nv};",
        f"  static constexpr int kRow = {row};",
        f"  static constexpr int kStride = {stride};",
        f"  static constexpr int kBlock = {block};",
        "  static CW_FN void run(const float* q, const float* qd, float* w) {",
    ]
    ind = " " * 4
    lines += [f"{ind}const float q{i} = q[{i}];" for i in range(t.nq)]
    lines += [f"{ind}const float v{i} = qd[{i}];" for i in range(t.nv)]
    lines += _straight_lines(live, ind)
    lines += [f"{ind}w[{i}] = {_ref(o)};" for i, o in enumerate(outputs)]
    lines += ["  }", "};", "", "CW_ENTRY_POINTS(ContactWrenches)", ""]
    layout = {"threads_a_block": block, "row_floats": row, "row_stride": stride,
              "shared_bytes_per_block": 4 * block * stride}
    return GeneratedSource(name, 1, "\n".join(lines), {}, ops_counts, layout)


# ---------------------------------------------------------------------------
# The centre-of-mass kinematics: the bodies' com velocities and the mass centre.


def com_velocity_program(t: ModelTables, ops, qrows, qdrows) -> list:
    """Each body's centre-of-mass velocity in the world over lists of
    per-env values: ``nbody * 3`` values, body by body. A body's com is
    ``ps[b] + Rs[b] com_b`` of :func:`forward_kinematics`, and its velocity
    ``sum_k J_k qd_k`` over the dofs that move the body, ``J_k`` a slide's
    world axis or a hinge's ``axis x (com - pivot)``, as :func:`contact_force`
    moves a contact point. The free root's first three dofs are slides along
    the world axes and its last three hinges about the body frame's axes
    through its origin, so this is the first-order velocity along the
    position flow ``q (+) t qd`` of ``physics/articulated.py::integrate_pos``
    at ``t = 0``."""
    Rs, ps, axes_w, pivots_w = forward_kinematics(t, ops, qrows)
    rows = []
    for b in range(t.nbody):
        pc = _vadd(ps[b], _matvec(Rs[b], t.coms[b]))
        vel = [0.0, 0.0, 0.0]
        for k in range(t.nv):
            if t.amask[b, k]:
                J = axes_w[k] if t.jtypes[k] == SLIDE else _cross(axes_w[k], _vsub(pc, pivots_w[k]))
                vel = _vadd(vel, _scale(J, qdrows[k]))
        rows += vel
    return rows


def mass_center_x_program(t: ModelTables, ops, qrows):
    """The whole robot's mass centre along x, ``sum_b m_b pc_b,x / sum_b
    m_b``, over lists of per-env values: each body's com x of
    :func:`forward_kinematics` times its share of the mass (folded in
    float64, rounded to float32 once), summed body by body."""
    Rs, ps, _, _ = forward_kinematics(t, ops, qrows)
    total = sum(t.masses)
    x = 0.0
    for b in range(t.nbody):
        x = _add(x, _mul(t.masses[b] / total, _add(ps[b][0], _dot3(Rs[b][0], t.coms[b]))))
    return x


def generate_com_source(model: ArticulatedModel, name: str) -> GeneratedSource:
    """Emit the centre-of-mass kernel source of ``model``: two programs over
    the same forward kinematics, with an entry point each.

    ``struct ComVelocity`` holds the widths, the block size and a
    ``__host__ __device__`` ``run(q, qd, v)`` that writes one env's
    ``nbody * 3`` values of :func:`com_velocity_program` to ``v``;
    ``struct MassCenterX`` a ``run(q)`` that returns the env's
    :func:`mass_center_x_program`. Each ``run`` is one C statement per live
    operation (the sine and cosine of one angle from one ``sincosf``). The
    text then instantiates the fixed kernels and entry points of
    ``csrc/com_kinematics.cuh``: under ``nvcc`` the launchers
    ``com_velocity_launch`` and ``mass_center_x_launch``, under a plain C++
    compiler the host loops ``com_velocity_host`` and ``mass_center_x_host``.
    The counts are by program (``layout``); ``substep_ops`` sums them.
    """
    t = model_tables(model)
    ops = SymOps()
    qrows = [ops.input(f"q{i}", varying=True) for i in range(t.nq)]
    qdrows = [ops.input(f"v{i}", varying=True) for i in range(t.nv)]
    velocity = [x if isinstance(x, Sym) else ops.const(x) for x in com_velocity_program(t, ops, qrows, qdrows)]
    velocity_live = _live(velocity)
    ops = SymOps()
    qrows = [ops.input(f"q{i}", varying=True) for i in range(t.nq)]
    center = mass_center_x_program(t, ops, qrows)
    center = center if isinstance(center, Sym) else ops.const(center)
    center_live = _live([center])
    row = 3 * t.nbody
    stride, block = _staged_rows(name, row, f"{t.nbody} bodies' velocities")
    velocity_ops, center_ops = _counts(velocity_live), _counts(center_live)
    ind = " " * 4
    lines = [
        f"// Generated by gymnasium_tpu_torch/ops/articulated_codegen.py for {name}: the",
        "// centre-of-mass kinematics. Do not edit: edit the generator.",
        f"// Each com_velocity call: {_listed(velocity_ops)}.",
        f"// Each mass_center_x call: {_listed(center_ops)}.",
        '#include "com_kinematics.cuh"',
        "",
        "struct ComVelocity {",
        f"  static constexpr int kNq = {t.nq};",
        f"  static constexpr int kNv = {t.nv};",
        f"  static constexpr int kRow = {row};",
        f"  static constexpr int kStride = {stride};",
        f"  static constexpr int kBlock = {block};",
        "  static COM_FN void run(const float* q, const float* qd, float* v) {",
    ]
    lines += [f"{ind}const float q{i} = q[{i}];" for i in range(t.nq)]
    lines += [f"{ind}const float v{i} = qd[{i}];" for i in range(t.nv)]
    lines += _straight_lines(velocity_live, ind)
    lines += [f"{ind}v[{i}] = {_ref(o)};" for i, o in enumerate(velocity)]
    lines += [
        "  }",
        "};",
        "",
        "struct MassCenterX {",
        f"  static constexpr int kNq = {t.nq};",
        f"  static constexpr int kBlock = {WRENCH_BLOCK};",
        "  static COM_FN float run(const float* q) {",
    ]
    lines += [f"{ind}const float q{i} = q[{i}];" for i in range(t.nq)]
    lines += _straight_lines(center_live, ind)
    lines += [f"{ind}return {_ref(center)};", "  }", "};", "", "COM_ENTRY_POINTS(ComVelocity, MassCenterX)", ""]
    total = collections.Counter(velocity_ops) + collections.Counter(center_ops)
    layout = {"threads_a_block": block, "row_floats": row, "row_stride": stride,
              "shared_bytes_per_block": 4 * block * stride, "com_velocity_ops": velocity_ops,
              "mass_center_x_ops": center_ops}
    return GeneratedSource(name, 1, "\n".join(lines), {}, dict(total), layout)
