"""Acrobot dynamics: RK4 over the two-link underactuated pendulum ODE (own
copy of the JAX package's ``envs/dynamics/acrobot.py``).

Written once for any array namespace ``xp`` (numpy, torch). Reference
classic_control/acrobot.py:202-244, the "book" variant of the Sutton
equations, with the ``wrap``/``bound`` post-steps. The host env class
passes :func:`wrap_exact`, the reference's scalar loop, for its angles.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple


class AcrobotParams(NamedTuple):
    """Link masses/lengths and integration parameters."""

    dt: Any = 0.2
    link_length_1: Any = 1.0
    link_length_2: Any = 1.0
    link_mass_1: Any = 1.0
    link_mass_2: Any = 1.0
    link_com_pos_1: Any = 0.5
    link_com_pos_2: Any = 0.5
    link_moi: Any = 1.0
    max_vel_1: Any = 4 * math.pi
    max_vel_2: Any = 9 * math.pi
    g: Any = 9.8
    reset_bound: Any = 0.1


def wrap(xp, x, low, high):
    """Wrap ``x`` into ``[low, high)`` by the floor remainder."""
    return ((x - low) % (high - low)) + low


def wrap_exact(x: float, low: float, high: float) -> float:
    """Scalar wrap by repeated subtraction: the reference's loop, which the
    floor remainder can miss by a last bit; the host env's path."""
    diff = high - low
    while x > high:
        x = x - diff
    while x < low:
        x = x + diff
    return x


def dsdt(xp, s, torque, p: AcrobotParams):
    """Time-derivative of ``[θ1, θ2, θ1', θ2']`` under ``torque`` (book eqs)."""
    m1, m2 = p.link_mass_1, p.link_mass_2
    l1 = p.link_length_1
    lc1, lc2 = p.link_com_pos_1, p.link_com_pos_2
    i1, i2 = p.link_moi, p.link_moi
    g = p.g
    theta1 = s[..., 0]
    theta2 = s[..., 1]
    dtheta1 = s[..., 2]
    dtheta2 = s[..., 3]

    d1 = m1 * lc1**2 + m2 * (l1**2 + lc2**2 + 2 * l1 * lc2 * xp.cos(theta2)) + i1 + i2
    d2 = m2 * (lc2**2 + l1 * lc2 * xp.cos(theta2)) + i2
    phi2 = m2 * lc2 * g * xp.cos(theta1 + theta2 - math.pi / 2.0)
    phi1 = (
        -m2 * l1 * lc2 * dtheta2**2 * xp.sin(theta2)
        - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * xp.sin(theta2)
        + (m1 * lc1 + m2 * l1) * g * xp.cos(theta1 - math.pi / 2)
        + phi2
    )
    # "book" variant
    ddtheta2 = (torque + d2 / d1 * phi1 - m2 * l1 * lc2 * dtheta1**2 * xp.sin(theta2) - phi2) / (
        m2 * lc2**2 + i2 - d2**2 / d1
    )
    ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
    return xp.stack((dtheta1, dtheta2, ddtheta1, ddtheta2), axis=-1)


def rk4_step(xp, s, torque, p: AcrobotParams):
    """Classic RK4 over one ``dt`` interval."""
    dt = p.dt
    k1 = dsdt(xp, s, torque, p)
    k2 = dsdt(xp, s + dt / 2.0 * k1, torque, p)
    k3 = dsdt(xp, s + dt / 2.0 * k2, torque, p)
    k4 = dsdt(xp, s + dt * k3, torque, p)
    return s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def integrate(xp, state, torque, p: AcrobotParams, wrap_fn=None):
    """One env tick: RK4, then the angles wrapped and the velocities bounded.

    ``wrap_fn(x, low, high)`` replaces the floor-remainder wrap (the host
    env class passes :func:`wrap_exact`).
    """
    ns = rk4_step(xp, state, torque, p)
    if wrap_fn is None:
        wrap_fn = lambda x, low, high: wrap(xp, x, low, high)  # noqa: E731
    th1 = wrap_fn(ns[..., 0], -math.pi, math.pi)
    th2 = wrap_fn(ns[..., 1], -math.pi, math.pi)
    v1 = xp.clip(ns[..., 2], -p.max_vel_1, p.max_vel_1)
    v2 = xp.clip(ns[..., 3], -p.max_vel_2, p.max_vel_2)
    return xp.stack((th1, th2, v1, v2), axis=-1)


def is_terminated(xp, state):
    """Free end above the bar: ``-cos θ1 - cos(θ1 + θ2) > 1``."""
    return -xp.cos(state[..., 0]) - xp.cos(state[..., 1] + state[..., 0]) > 1.0


def observe(xp, state):
    """``[cos θ1, sin θ1, cos θ2, sin θ2, θ1', θ2']``."""
    return xp.stack(
        (
            xp.cos(state[..., 0]),
            xp.sin(state[..., 0]),
            xp.cos(state[..., 1]),
            xp.sin(state[..., 1]),
            state[..., 2],
            state[..., 3],
        ),
        axis=-1,
    )
