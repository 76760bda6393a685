"""Static tables of the articulated (MuJoCo-class) engine.

Counterpart of the JAX package's ``physics/articulated.py``: the robot
description (:class:`JointSpec`, :class:`BodySpec`, :class:`ArticulatedModel`),
the static helpers the substep generator reads (``init_qpos``, the dof
ancestry masks, the free-root tests, the folded contact and limit constants),
and the batched kinematics the robots' observations and rewards read
(``dof_positions``, ``integrate_pos``, ``fk``, ``fk_full`` and the helpers of
:func:`make_dynamics`), with the geometric Jacobians, the mass matrix and the
unrolled Cholesky solve (:func:`spd_solve`) that Swimmer's fluid drag reads,
the Newton-Euler bias and the energies. A model steps only through the
generated substep of :mod:`gymnasium_tpu_torch.ops.articulated_step`:
``make_dynamics(model)["step"]`` is one substep of its plain twin, and
:func:`step_fn` is the fused step itself (the kernel on a CUDA tensor).

The batched helpers take ``(N, nq)``/``(N, nv)`` float32 tensors and compute
on their device. Small products are written as broadcast multiply-sums, as
the JAX helpers write them, with no scatter, so two calls give the same bits.
The contact wrenches are the exception: the program of the substep's own
contact forces, generated per model as one kernel on the card and run as its
plain twin on the CPU (:mod:`gymnasium_tpu_torch.ops.contact_wrenches`).

Joints are slide or hinge about fixed axes. With ``root_free=True`` dofs 0-5
form a free root: qpos holds ``[x y z | qw qx qy qz | joints]`` (``nq = nv +
1``) and ``qvel[3:6]`` is the body-frame angular velocity.
"""

from __future__ import annotations

import hashlib
from typing import Any, NamedTuple

import numpy as np
import torch

from gymnasium_tpu_torch.utils.tracing import span

__all__ = [
    "SLIDE",
    "HINGE",
    "JointSpec",
    "BodySpec",
    "ArticulatedModel",
    "model_digest",
    "init_qpos",
    "ancestor_dof_mask",
    "strict_dof_ancestors",
    "contact_constants",
    "limit_constants",
    "dof_positions",
    "integrate_pos",
    "fk",
    "fk_full",
    "make_dynamics",
    "step_fn",
    "spd_solve",
]

SLIDE = 0
HINGE = 1


class JointSpec(NamedTuple):
    """Per-dof tables (length nv)."""

    body: np.ndarray  # (nv,) index of the body this dof moves
    jtype: np.ndarray  # (nv,) SLIDE or HINGE
    axis: np.ndarray  # (nv, 3) axis in the pre-joint frame
    anchor: np.ndarray  # (nv, 3) anchor point in the pre-joint frame
    damping: np.ndarray  # (nv,)
    limited: np.ndarray  # (nv,) bool
    lower: np.ndarray  # (nv,)
    upper: np.ndarray  # (nv,)
    stiffness: np.ndarray  # (nv,) joint spring stiffness toward the reference
    armature: np.ndarray  # (nv,) rotor inertia added to the mass diagonal
    ref: np.ndarray  # (nv,) joint value at the rest pose


class BodySpec(NamedTuple):
    """Per-body tables (length nbody), in topological order."""

    parent: np.ndarray  # (nbody,) parent body index (-1: attached to the world)
    pos: np.ndarray  # (nbody, 3) fixed offset in the parent frame
    quat: np.ndarray  # (nbody, 4) fixed rotation (w, x, y, z) in the parent frame
    mass: np.ndarray  # (nbody,)
    com: np.ndarray  # (nbody, 3) center of mass in the body frame
    inertia: np.ndarray  # (nbody, 3, 3) about the com, body frame
    dof_start: np.ndarray  # (nbody,) first dof of this body
    dof_count: np.ndarray  # (nbody,)


class ArticulatedModel(NamedTuple):
    """A full robot description."""

    bodies: BodySpec
    joints: JointSpec
    # contact spheres: (nc,) body index, (nc, 3) offset, (nc,) radius
    contact_body: np.ndarray
    contact_pos: np.ndarray
    contact_radius: np.ndarray
    # actuators: (nu,) dof index, (nu,) gear, (nu, 2) ctrlrange
    act_dof: np.ndarray
    act_gear: np.ndarray
    act_ctrlrange: np.ndarray
    gravity: float = -9.81
    timestep: float = 0.002
    fluid_density: float = 0.0
    fluid_viscosity: float = 0.0
    # ceiling on the per-contact penalty spring: a scalar or an (nc,) array
    contact_stiffness: Any = 100000.0
    contact_damping: float = 100.0
    # contact damping ratio: c = ratio * sqrt(k_c * m_eff); 2.0 is critical
    contact_damp_ratio: float = 1.4
    # explicit-stability fraction: k_c <= m_eff * (alpha / dt)^2
    contact_alpha: float = 1.0
    friction: float = 1.0
    limit_stiffness: float = 500.0
    ground_z: float = 0.0
    root_free: bool = False
    site_body: np.ndarray = np.zeros((0,), dtype=np.int32)
    site_pos: np.ndarray = np.zeros((0, 3))

    @property
    def nv(self) -> int:
        return len(self.joints.body)

    @property
    def nq(self) -> int:
        return self.nv + 1 if self.root_free else self.nv

    @property
    def nu(self) -> int:
        return len(self.act_dof)

    @property
    def nbody(self) -> int:
        """Body count including the implicit world body (MuJoCo convention)."""
        return len(self.bodies.parent) + 1

    @property
    def body_mass(self) -> np.ndarray:
        """(nbody,) masses with the world's 0 at row 0 (MuJoCo layout)."""
        return np.concatenate([[0.0], np.asarray(self.bodies.mass, dtype=np.float64)])

    @property
    def ntendon(self) -> int:
        """Tendons are not modelled by this engine."""
        return 0


def model_digest(model: ArticulatedModel) -> str:
    """A digest of every field of ``model``: its arrays' dtypes, shapes and bytes."""
    digest = hashlib.sha256()

    def add(value):
        if isinstance(value, tuple) and hasattr(value, "_fields"):
            for field in value:
                add(field)
            return
        array = np.ascontiguousarray(np.asarray(value))
        digest.update(f"{array.dtype.str}{array.shape}".encode())
        digest.update(array.tobytes())

    add(model)
    return digest.hexdigest()


def quat_to_mat_np(q) -> np.ndarray:
    """(w, x, y, z) unit quaternion -> 3x3 rotation matrix, in float64."""
    w, x, y, z = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def init_qpos(model: ArticulatedModel) -> np.ndarray:
    """The rest-pose position vector (nq,), float64.

    A free root starts at the root body's fixed pos and quat (qpos holds the
    absolute world pose), followed by the joint references.
    """
    ref = np.asarray(model.joints.ref, dtype=np.float64)
    if not model.root_free:
        return ref.copy()
    root = int(model.joints.body[0])
    return np.concatenate(
        [np.asarray(model.bodies.pos[root]), np.asarray(model.bodies.quat[root]), ref[6:]]
    )


def is_free_root_body(model: ArticulatedModel, b: int) -> bool:
    return (
        model.root_free
        and int(model.bodies.dof_start[b]) == 0
        and int(model.bodies.dof_count[b]) == 6
    )


def q_index(model: ArticulatedModel, k: int) -> int:
    """Position index of dof ``k`` (the root quaternion shifts joints by 1)."""
    return k + 1 if model.root_free and k >= 6 else k


def ancestor_dof_mask(model: ArticulatedModel) -> np.ndarray:
    """Static (nbody, nv) bool: dof k moves body b (k belongs to b or an
    ancestor of b)."""
    nbody = len(model.bodies.parent)
    mask = np.zeros((nbody, model.nv), dtype=bool)
    for b in range(nbody):
        node = b
        while node >= 0:
            s = int(model.bodies.dof_start[node])
            c = int(model.bodies.dof_count[node])
            mask[b, s : s + c] = True
            node = int(model.bodies.parent[node])
    return mask


def strict_dof_ancestors(model: ArticulatedModel) -> np.ndarray:
    """Static (nv, nv) bool: dof j is applied before dof k on k's chain
    (ancestor-body dofs plus same-body dofs with a smaller index)."""
    nv = model.nv
    body_mask = ancestor_dof_mask(model)
    strict = np.zeros((nv, nv), dtype=bool)
    for k in range(nv):
        b = int(model.joints.body[k])
        parent = int(model.bodies.parent[b])
        if parent >= 0:
            strict[k] = body_mask[parent]
        s = int(model.bodies.dof_start[b])
        strict[k, s:k] = True
    return strict


def contact_constants(model: ArticulatedModel) -> tuple[np.ndarray, np.ndarray]:
    """The soft contacts' spring ``k_c`` and damper ``c_c``, (nc,) float64.

    The spring is capped for explicit stability at the contacting body's
    mass: ``k_c <= m_eff (alpha / dt)^2``, and ``c_c = ratio sqrt(k_c m_eff)``.
    """
    m_eff = np.maximum(np.asarray(model.bodies.mass, np.float64)[np.asarray(model.contact_body, int)], 1e-3)
    k_c = np.minimum(model.contact_stiffness, m_eff * (model.contact_alpha / float(model.timestep)) ** 2)
    return k_c, model.contact_damp_ratio * np.sqrt(k_c * m_eff)


def limit_constants(model: ArticulatedModel) -> tuple[np.ndarray, np.ndarray]:
    """The joint-limit springs ``limit_k`` and dampers ``limit_c``, (nv,) float64.

    The spring is scaled to the dof's peak actuator torque, so that a full
    push penetrates about 0.05 rad, and capped for explicit stability.
    """
    tau_max = np.zeros(model.nv)
    for d, g in zip(np.asarray(model.act_dof, int), np.abs(np.asarray(model.act_gear, np.float64))):
        tau_max[d] = max(tau_max[d], g)
    m_dof = np.asarray(model.joints.armature, np.float64) + 0.02
    dt = float(model.timestep)
    k_lim = np.clip(np.maximum(model.limit_stiffness, tau_max / 0.05), None, 0.25 * m_dof / dt**2)
    return k_lim, 1.4 * np.sqrt(k_lim * m_dof)


# ---------------------------------------------------------------------------
# Batched kinematics over (N, ...) float32 tensors.


def _mm(A, B):
    """``A @ B`` over the last two axes of 3x3 matrices, as a multiply-sum."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def _mv(A, v):
    """``A @ v`` for 3x3 matrices and 3-vectors, as a multiply-sum."""
    return torch.sum(A * v[..., None, :], dim=-1)


def _quat_to_mat(q):
    """(N, 4) quaternions (w, x, y, z) -> (N, 3, 3). Divides by ``|q|^2``, so
    an unnormalised quaternion gives a rotation."""
    n = torch.sum(q * q, dim=-1)
    w, x, y, z = q.unbind(-1)
    s = 2.0 / torch.clamp(n, min=1e-12)
    rows = [
        [1 - s * (y * y + z * z), s * (x * y - w * z), s * (x * z + w * y)],
        [s * (x * y + w * z), 1 - s * (x * x + z * z), s * (y * z - w * x)],
        [s * (x * z - w * y), s * (y * z + w * x), 1 - s * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _quat_mul(a, b):
    """Hamilton product of (N, 4) quaternions (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _rotvec_to_quat(v):
    """Exponential map (N, 3) rotation vectors -> (N, 4) quaternions, on its
    Taylor series below ``|v|^2 = 1e-10`` (the JAX helper's double select,
    so a derivative never sees the square root of 0)."""
    theta2 = torch.sum(v * v, dim=-1)
    big = theta2 > 1e-10
    theta = torch.sqrt(torch.where(big, theta2, torch.ones_like(theta2)))
    half = 0.5 * theta
    sinc_half = torch.where(big, torch.sin(half) / theta, 0.5 - theta2 / 48.0)
    cos_half = torch.where(big, torch.cos(half), 1.0 - theta2 / 8.0 + theta2 * theta2 / 384.0)
    return torch.cat([cos_half[..., None], sinc_half[..., None] * v], dim=-1)


def dof_positions(model: ArticulatedModel, q):
    """Per-dof positions (N, nv) for springs and limits: a free root's
    quaternion block gives zeros (its dofs are never limited or sprung)."""
    if not model.root_free:
        return q
    return torch.cat([q[:, :3], torch.zeros_like(q[:, :3]), q[:, 7:]], dim=1)


def integrate_pos(model: ArticulatedModel, q, v, dt):
    """``q (+) dt v``: Euler for slides and hinges; for a free root the
    quaternion turns by ``exp(dt omega / 2)`` on the right (``omega`` is in
    the body frame) and is renormalised. ``dt`` is a float or a 0-d tensor,
    so a forward derivative along ``dt`` gives the velocity of a point."""
    if not model.root_free:
        return q + dt * v
    pos = q[:, :3] + dt * v[:, :3]
    quat = _quat_mul(q[:, 3:7], _rotvec_to_quat(dt * v[:, 3:6]))
    quat = quat / torch.sqrt(torch.sum(quat * quat, dim=-1, keepdim=True) + 1e-24)
    return torch.cat([pos, quat, q[:, 7:] + dt * v[:, 6:]], dim=1)


class _Constants:
    """A model's static tables as float32 tensors, made once a device."""

    def __init__(self, model: ArticulatedModel):
        nv = model.nv
        axes = np.asarray(model.joints.axis, np.float64)
        skew = np.zeros((nv, 3, 3))
        skew[:, 0, 1], skew[:, 0, 2], skew[:, 1, 2] = -axes[:, 2], axes[:, 1], -axes[:, 0]
        skew[:, 1, 0], skew[:, 2, 0], skew[:, 2, 1] = axes[:, 2], -axes[:, 1], axes[:, 0]
        limit_k, limit_c = limit_constants(model)
        self._np = {
            "body_rot": np.stack([quat_to_mat_np(quat) for quat in model.bodies.quat]),
            "body_pos": model.bodies.pos,
            "axis": axes,
            "anchor": model.joints.anchor,
            "ref": model.joints.ref,
            "skew": skew,
            "outer": axes[:, :, None] * axes[:, None, :],
            "eye": np.eye(3),
            "slide": (np.asarray(model.joints.jtype) == SLIDE)[:, None],
            "mass": model.bodies.mass,
            "com": model.bodies.com,
            "contact_body": np.asarray(model.contact_body, np.int64),
            "contact_pos": np.asarray(model.contact_pos).reshape(-1, 3),
            "limited": np.asarray(model.joints.limited, bool),
            "lower": model.joints.lower,
            "upper": model.joints.upper,
            "limit_k": limit_k,
            "limit_c": limit_c,
        }
        self._on: dict[torch.device, dict[str, torch.Tensor]] = {}

    def on(self, device: torch.device) -> dict[str, torch.Tensor]:
        tables = self._on.get(device)
        if tables is None:
            tables = self._on[device] = {k: _tensor(v, device) for k, v in self._np.items()}
        return tables


def _tensor(x, device) -> torch.Tensor:
    x = np.asarray(x)
    if x.dtype == np.bool_ or x.dtype.kind in "iu":
        return torch.as_tensor(x, device=device)
    return torch.as_tensor(x.astype(np.float32), device=device)


def _fk(model: ArticulatedModel, c: dict, q, full: bool):
    """Forward kinematics over the bodies in order, the local transforms of
    every dof made at once. With ``full`` it also records each dof's world
    axis and pivot where the dof is applied."""
    nbody, nv = len(model.bodies.parent), model.nv
    qj = torch.stack([q[:, q_index(model, k)] for k in range(nv)], dim=1) - c["ref"]
    cos, sin = torch.cos(qj)[:, :, None, None], torch.sin(qj)[:, :, None, None]
    rot_dof = c["eye"] * cos + sin * c["skew"] + (1 - cos) * c["outer"]  # (N, nv, 3, 3)
    hinge_shift = c["anchor"] - _mv(rot_dof, c["anchor"])  # anchor - R_j anchor
    slide_shift = c["axis"] * qj[:, :, None]
    Rs, ps = [None] * nbody, [None] * nbody
    axes_w, pivots_w = [None] * nv, [None] * nv
    for b in range(nbody):
        parent = int(model.bodies.parent[b])
        start, count = int(model.bodies.dof_start[b]), int(model.bodies.dof_count[b])
        if is_free_root_body(model, b):
            # the free joint's qpos is the body frame's world pose
            R, p = _quat_to_mat(q[:, 3:7]), q[:, 0:3]
            for k in range(3):
                axes_w[start + k] = c["eye"][k].expand_as(p)
                pivots_w[start + k] = torch.zeros_like(p)
                axes_w[start + 3 + k] = R[:, :, k]
                pivots_w[start + 3 + k] = p
            Rs[b], ps[b] = R, p
            continue
        if parent < 0:
            R = c["body_rot"][b].expand(q.shape[0], 3, 3)
            p = c["body_pos"][b].expand(q.shape[0], 3)
        else:
            R = _mm(Rs[parent], c["body_rot"][b])
            p = ps[parent] + _mv(Rs[parent], c["body_pos"][b])
        for k in range(start, start + count):
            if full:
                axes_w[k] = _mv(R, c["axis"][k])
            if int(model.joints.jtype[k]) == SLIDE:
                if full:
                    pivots_w[k] = torch.zeros_like(p)
                p = p + _mv(R, slide_shift[:, k])
            else:
                if full:
                    pivots_w[k] = p + _mv(R, c["anchor"][k])
                p = p + _mv(R, hinge_shift[:, k])
                R = _mm(R, rot_dof[:, k])
        Rs[b], ps[b] = R, p
    R, p = torch.stack(Rs, dim=1), torch.stack(ps, dim=1)
    if not full:
        return R, p
    return R, p, torch.stack(axes_w, dim=1), torch.stack(pivots_w, dim=1)


def fk(model: ArticulatedModel, q):
    """World rotations R (N, nbody, 3, 3) and frame origins p (N, nbody, 3)."""
    return _fk(model, _Constants(model).on(q.device), q, full=False)


def fk_full(model: ArticulatedModel, q):
    """:func:`fk` that also records each dof's world axis and pivot at the
    moment the dof is applied: ``(R, p, axes_w (N, nv, 3), pivots_w (N, nv, 3))``.
    A slide's pivot is 0; a free root's rotation axes are the columns of R."""
    return _fk(model, _Constants(model).on(q.device), q, full=True)


def spd_solve(A, b):
    """Solve the symmetric positive definite systems ``A x = b``, ``A`` (N, n, n)
    and ``b`` (N, n), by a Cholesky factorisation unrolled over the columns,
    as the JAX package's ``_spd_solve`` does for one system."""
    n = A.shape[-1]
    below = torch.arange(n, device=A.device)
    L = torch.zeros_like(A)
    for j in range(n):
        c = A[:, :, j] - torch.sum(L * L[:, j, None, :], dim=2)
        d = torch.sqrt(torch.clamp(c[:, j], min=1e-12))
        L[:, :, j] = torch.where(below >= j, c / d[:, None], 0.0)
    # forward: L y = b
    y = torch.zeros_like(b)
    r = b
    for j in range(n):
        y[:, j] = r[:, j] / L[:, j, j]
        r = r - L[:, :, j] * y[:, j, None]
    # backward: L^T x = y
    x = torch.zeros_like(b)
    s = y
    for j in reversed(range(n)):
        x[:, j] = s[:, j] / L[:, j, j]
        s = s - L[:, j, :] * x[:, j, None]
    return x


def make_dynamics(model: ArticulatedModel) -> dict:
    """Batched helpers of one model, the JAX ``make_dynamics``'s that the
    robots read, each on the device of its arguments:

    - ``fk(q) -> (R, p)``;
    - ``com_world(q) -> (pc (N, nbody, 3), R)``, the bodies' centres of mass;
    - ``contact_points(q) -> (N, nc, 3)``, the contact spheres' centres;
    - ``contact_wrenches(q, qd) -> (N, nbody, 6)``, each body's external
      contact wrench ``[torque, force]`` about its com (``cfrc_ext``), with
      the substep's contact forces: one launch of the model's generated
      kernel on a CUDA tensor, its plain twin on a CPU tensor
      (``ops/contact_wrenches.py``), zeros with no launch for a model
      without contact spheres;
    - ``limit_torques(q, qd) -> (N, nv)``, the joint-limit penalty torques;
    - ``jacobians(q) -> (pc, R, Jv, Jw)``, the bodies' centres of mass and
      rotations with their geometric Jacobians (N, nbody, nv, 3): a hinge
      moves a point by ``axis x (point - pivot)`` and turns the body about
      its axis, a slide moves it along its axis, and only a body's own and
      its ancestors' dofs move it (``pc_dot = sum_k Jv[:, :, k] qd_k``);
    - ``mass_matrix(q) -> (N, nv, nv)``, ``X^T X`` plus the armature, with
      ``X`` the rows ``sqrt(m) Jv^T`` and ``(R L)^T Jw^T`` of every body,
      ``L`` the Cholesky factor of its inertia (the JAX helper's Gram form);
    - ``bias(q, qd) -> (N, nv)``, the Newton-Euler velocity bias with gravity
      and the joint springs, as the substep program computes it
      (``ops/articulated_codegen.py::kinematics_and_bias`` over the twin's
      rows);
    - ``kinetic_energy(q, qd) -> (N,)``, from the bodies' velocities along
      the position flow ``q (+) t qd`` (a forward derivative of
      :func:`integrate_pos`, independent of the closed-form Jacobians), and
      ``potential(q) -> (N,)``, gravity and the joint springs;
    - ``step(q, qd, ctrl) -> (q', qd')``, one substep of the program the
      fused step's plain twin runs (``ops/articulated_step.py``), on any
      device.
    """
    constants = _Constants(model)
    nbody, nc = len(model.bodies.parent), len(model.contact_body)
    inertia_chol = np.linalg.cholesky(np.asarray(model.bodies.inertia) + 1e-12 * np.eye(3))
    gram = {
        "sqrt_mass": np.sqrt(np.asarray(model.bodies.mass))[:, None, None],
        "inertia_chol": inertia_chol,
        "body_mask": ancestor_dof_mask(model)[:, :, None],
        "armature": np.diag(np.asarray(model.joints.armature, np.float64)),
        "armature_v": np.asarray(model.joints.armature, np.float64),
        "inertia": np.asarray(model.bodies.inertia, np.float64),
        "mass": np.asarray(model.bodies.mass, np.float64),
        "stiffness": np.asarray(model.joints.stiffness, np.float64),
    }
    gram_on: dict[torch.device, dict[str, torch.Tensor]] = {}

    def com_world(q):
        c = constants.on(q.device)
        R, p = _fk(model, c, q, full=False)
        return p + _mv(R, c["com"]), R

    def _points(c, R, p):
        cb = c["contact_body"]
        return p[:, cb] + _mv(R[:, cb], c["contact_pos"])

    def contact_points(q):
        c = constants.on(q.device)
        return _points(c, *_fk(model, c, q, full=False))

    wrenches = []

    def contact_wrenches(q, qd):
        with span("mujoco.contact_wrenches"):
            if nc == 0:
                return torch.zeros((q.shape[0], nbody, 6), dtype=q.dtype, device=q.device)
            if not wrenches:
                # imported here: the generator imports this module
                from gymnasium_tpu_torch.ops.contact_wrenches import contact_wrenches_of

                wrenches.append(contact_wrenches_of(model))
            return wrenches[0](q, qd)

    def limit_torques(q, qd):
        c = constants.on(q.device)
        qj = dof_positions(model, q)
        below = torch.clamp(qj - c["lower"], max=0.0)
        above = torch.clamp(qj - c["upper"], min=0.0)
        violating = (below < 0.0) | (above > 0.0)
        tau = -c["limit_k"] * (below + above) - torch.where(violating, c["limit_c"] * qd, 0.0)
        return torch.where(c["limited"], tau, 0.0)

    def jacobians(q):
        c = constants.on(q.device)
        R, p, aw, ow = _fk(model, c, q, full=True)
        pc = p + _mv(R, c["com"])
        aw_b = aw[:, None]  # (N, 1, nv, 3)
        mask = gram_tables(q.device)["body_mask"]
        Jv = torch.where(c["slide"], aw_b, torch.linalg.cross(aw_b, pc[:, :, None] - ow[:, None], dim=-1)) * mask
        Jw = torch.where(c["slide"], 0.0, aw_b) * mask
        return pc, R, Jv, Jw

    def gram_tables(device):
        if device not in gram_on:
            gram_on[device] = {k: _tensor(v, device) for k, v in gram.items()}
        return gram_on[device]

    def mass_matrix(q):
        g = gram_tables(q.device)
        _, R, Jv, Jw = jacobians(q)
        lin = g["sqrt_mass"] * Jv.transpose(-1, -2)  # (N, nbody, 3, nv)
        RL = _mm(R, g["inertia_chol"])
        ang = torch.sum(RL[..., :, :, None] * Jw.transpose(-1, -2)[..., :, None, :], dim=-3)
        X = torch.cat([lin, ang], dim=2).reshape(q.shape[0], 6 * nbody, model.nv)
        return torch.sum(X[:, :, :, None] * X[:, :, None, :], dim=1) + g["armature"]

    def kinetic_energy(q, qd):
        g = gram_tables(q.device)

        def flow(t):
            return com_world(integrate_pos(model, q, qd, t))

        zero = torch.zeros((), dtype=q.dtype, device=q.device)
        (_, R), (pc_dot, R_dot) = torch.func.jvp(flow, (zero,), (torch.ones_like(zero),))
        # the world angular velocity from skew(R_dot R^T)
        W = torch.sum(R_dot[..., :, None, :] * R[..., None, :, :], dim=-1)
        omega = torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)
        I_world = _mm(_mm(R, g["inertia"]), R.transpose(-1, -2))
        t_lin = 0.5 * torch.sum(g["mass"] * torch.sum(pc_dot * pc_dot, dim=-1), dim=-1)
        t_ang = 0.5 * torch.sum(I_world * omega[..., :, None] * omega[..., None, :], dim=(1, 2, 3))
        t_arm = 0.5 * torch.sum(g["armature_v"] * qd * qd, dim=-1)
        return t_lin + t_ang + t_arm

    def potential(q):
        c, g = constants.on(q.device), gram_tables(q.device)
        pc, _ = com_world(q)
        dq = dof_positions(model, q) - c["ref"]
        spring = 0.5 * torch.sum(g["stiffness"] * dq * dq, dim=-1)
        return -torch.sum(g["mass"] * model.gravity * pc[..., 2], dim=-1) + spring

    substep = []

    def program():
        """The fused step of one substep, whose twin runs the program."""
        if not substep:
            # imported here: the generator imports this module
            from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

            substep.append(make_fused_step(model, 1))
        return substep[0]

    def bias(q, qd):
        from gymnasium_tpu_torch.ops.articulated_codegen import kinematics_and_bias
        from gymnasium_tpu_torch.ops.codegen import TorchOps

        rows = kinematics_and_bias(program().tables, TorchOps(q.device), list(q.T), list(qd.T))[-1]
        return torch.stack([torch.as_tensor(r, dtype=q.dtype, device=q.device).expand(q.shape[0]) for r in rows], dim=1)

    def step(q, qd, ctrl):
        return program().reference(q, qd, ctrl)

    return {
        "fk": lambda q: _fk(model, constants.on(q.device), q, full=False),
        "com_world": com_world,
        "contact_points": contact_points,
        "contact_wrenches": contact_wrenches,
        "limit_torques": limit_torques,
        "jacobians": jacobians,
        "mass_matrix": mass_matrix,
        "bias": bias,
        "kinetic_energy": kinetic_energy,
        "potential": potential,
        "step": step,
    }


def step_fn(model: ArticulatedModel, frame_skip: int = 1, name: str = "model"):
    """The fused step ``(q, qd, ctrl) -> (q', qd')`` of ``frame_skip``
    substeps of ``model``: the generated kernel on CUDA tensors, its plain
    twin on CPU tensors (:func:`~gymnasium_tpu_torch.ops.articulated_step.make_fused_step`,
    whose ``name`` names the build)."""
    from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

    return make_fused_step(model, frame_skip, name)
