"""Static tables of the articulated (MuJoCo-class) engine.

Counterpart of the numpy layer of the JAX package's
``physics/articulated.py``: the robot description (:class:`JointSpec`,
:class:`BodySpec`, :class:`ArticulatedModel`) and the static helpers the
substep generator reads (``init_qpos``, the dof ancestry masks, the free-root
tests). The batched engine ``make_dynamics`` is not ported yet; the port
steps a model only through the generated substep of
:mod:`gymnasium_tpu_torch.ops.articulated_step`.

Joints are slide or hinge about fixed axes. With ``root_free=True`` dofs 0-5
form a free root: qpos holds ``[x y z | qw qx qy qz | joints]`` (``nq = nv +
1``) and ``qvel[3:6]`` is the body-frame angular velocity.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

__all__ = [
    "SLIDE",
    "HINGE",
    "JointSpec",
    "BodySpec",
    "ArticulatedModel",
    "init_qpos",
    "ancestor_dof_mask",
    "strict_dof_ancestors",
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
