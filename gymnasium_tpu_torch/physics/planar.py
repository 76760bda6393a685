"""Static tables of the planar (Box2D-class) engine.

Counterpart of the spec types of the JAX package's ``physics/planar.py``: a
world is a fixed set of bodies, revolute joints (limits, motors) and ground
contact probes, with the solver's constants. The dynamic state is a ``(B,
6)`` row ``[x, y, angle, vx, vy, omega]`` per body. The batched engine
``world_step`` is not ported yet; the port steps a world only through the
generated substep of :mod:`gymnasium_tpu_torch.ops.planar_step`, which runs
the same solver.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["BodySpec", "JointSpec", "ContactSpec", "PlanarWorld"]


class BodySpec(NamedTuple):
    """Static per-body properties."""

    inv_mass: np.ndarray  # (B,), 0 for static bodies
    inv_inertia: np.ndarray  # (B,)


class JointSpec(NamedTuple):
    """Revolute joints: point constraint + optional limits/motors."""

    body_a: np.ndarray  # (J,) parent index
    body_b: np.ndarray  # (J,) child index
    anchor_a: np.ndarray  # (J, 2) anchor in a's local frame
    anchor_b: np.ndarray  # (J, 2) anchor in b's local frame
    lower: np.ndarray  # (J,) lower joint-angle limit
    upper: np.ndarray  # (J,) upper limit
    ref_angle: np.ndarray  # (J,) angle_b - angle_a at the rest pose


class ContactSpec(NamedTuple):
    """Candidate contact probes (local points tested against the ground)."""

    body: np.ndarray  # (C,) body index
    point: np.ndarray  # (C, 2) local coordinates
    friction: np.ndarray  # (C,)


class PlanarWorld(NamedTuple):
    """A full static world description."""

    bodies: BodySpec
    joints: JointSpec
    contacts: ContactSpec
    gravity: float = -10.0
    dt: float = 1.0 / 50.0
    velocity_iterations: int = 8
    position_iterations: int = 4
    baumgarte: float = 0.2  # position-pass contact correction factor (b2_baumgarte)
    contact_slop: float = 0.005
    max_correction: float = 0.2  # per-iteration position clamp (b2_maxLinearCorrection)
    # Per-iteration clamp on the joint point-constraint position correction:
    # 0.0 solves the full anchor error in one shot per iteration; > 0 corrects
    # at most this many metres of anchor error an iteration (the walker's
    # world uses 0.2). The generated substep does not implement the clamp and
    # refuses a world that sets it.
    joint_correction_clamp: float = 0.0
