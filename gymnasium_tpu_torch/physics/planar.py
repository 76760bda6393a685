"""The planar (Box2D-class) engine: static world tables and ``world_step``.

Counterpart of the JAX package's ``physics/planar.py``: a world is a fixed
set of bodies, revolute joints (limits, motors) and ground contact probes,
with the solver's constants. The dynamic state is a ``(B, 6)`` row ``[x, y,
angle, vx, vy, omega]`` per body.

:func:`world_step` advances a batch of worlds one tick. It is the program of
:mod:`gymnasium_tpu_torch.ops.planar_codegen` over ``(N,)`` torch tensors,
the one solver program the port has: the generated CUDA kernel of
:mod:`gymnasium_tpu_torch.ops.planar_step` runs it too, several ticks a
launch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["BodySpec", "JointSpec", "ContactSpec", "PlanarWorld", "joint_angles", "world_step"]


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
    # at most this many metres of anchor error an iteration (Box2D-style
    # bounded sub-pulls; the walker's world uses 0.2, so its 0.53 m
    # creation-pose hip gap closes over several iterations).
    joint_correction_clamp: float = 0.0


def joint_angles(state: torch.Tensor, world: PlanarWorld) -> tuple[torch.Tensor, torch.Tensor]:
    """Joint angles and speeds ``(..., J)`` of body rows ``state`` (..., B, 6):
    ``angle_b - angle_a - ref_angle`` and ``omega_b - omega_a``, as the JAX
    ``joint_angles``. The reference angles are float32 on the state's device."""
    a = torch.as_tensor(np.asarray(world.joints.body_a), dtype=torch.long, device=state.device)
    b = torch.as_tensor(np.asarray(world.joints.body_b), dtype=torch.long, device=state.device)
    ref = torch.as_tensor(np.asarray(world.joints.ref_angle), dtype=state.dtype, device=state.device)
    angle = state[..., 2]
    omega = state[..., 5]
    return angle[..., b] - angle[..., a] - ref, omega[..., b] - omega[..., a]


def world_step(
    state: torch.Tensor,
    world: PlanarWorld,
    motor_speed,
    motor_torque,
    ground_height_fn,
    external_force: torch.Tensor | None = None,
    warm_start=None,
):
    """Advance a batch of worlds one ``world.dt``, as the JAX ``world_step``.

    Args:
        state: (N, B, 6) body rows.
        motor_speed: (J,) or (N, J) target relative angular velocities.
        motor_torque: (J,) or (N, J) max motor torques (0 disables a motor).
        ground_height_fn: ``f(x) -> ground_y`` over (N,) tensors.
        external_force: optional (N, B, 3) ``[fx, fy, torque]`` per body.
        warm_start: optional ``(j_imp (N, J, 5), c_imp (N, C, 2))``: the
            previous step's accumulated impulses (Box2D warm starting); a
            contact whose depth is not positive drops its impulse.

    Returns:
        ``(new_state, contact_flags (N, C) bool, (j_imp, c_imp))``, float32.
        Joint impulse rows are ``[motor, low, up, px, py]``, contact rows
        ``[normal, tangent]``; the flags are each probe's pre-step
        ``depth > 0``.
    """
    # imported here: the ops package imports this module's tables
    from gymnasium_tpu_torch.ops.codegen import TorchOps
    from gymnasium_tpu_torch.ops.planar_codegen import planar_tables, run_twin

    n, dev = state.shape[0], state.device
    t = planar_tables(world, None, substeps=1, external=external_force is not None)
    if warm_start is None:
        warm_start = (
            torch.zeros((n, t.njoint, 5), dtype=torch.float32, device=dev),
            torch.zeros((n, t.ncontact, 2), dtype=torch.float32, device=dev),
        )

    def per_env(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev).expand(n, t.njoint)

    bodies, jimp, cimp, flags = run_twin(
        t, TorchOps(dev), ground_height_fn, state, external_force, *warm_start,
        per_env(motor_speed), per_env(motor_torque),
    )
    return bodies, flags, (jimp, cimp)
