"""Pendulum swing-up dynamics (own copy of the JAX package's ``envs/dynamics/pendulum.py``).

Written once for any array namespace ``xp`` (numpy, torch). Reference
classic_control/pendulum.py:126-147: explicit Euler with the torque already
clipped, and the ``angle_normalize`` cost. ``%`` is the floor remainder in
numpy, torch and ``jnp`` alike (``torch.fmod`` would truncate instead).
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple


class PendulumParams(NamedTuple):
    """Dynamics parameters of the torque-controlled pendulum."""

    max_speed: Any = 8.0
    max_torque: Any = 2.0
    dt: Any = 0.05
    g: Any = 10.0
    m: Any = 1.0
    l: Any = 1.0
    reset_x: Any = math.pi  # |theta| reset bound
    reset_y: Any = 1.0  # |theta_dot| reset bound


def angle_normalize(xp, x):
    """Map an angle into [-pi, pi)."""
    return ((x + math.pi) % (2 * math.pi)) - math.pi


def integrate(xp, state, u, p: PendulumParams):
    """One Euler tick: ``state = [theta, theta_dot]``, ``u`` already clipped."""
    th = state[..., 0]
    thdot = state[..., 1]
    newthdot = thdot + (3.0 * p.g / (2.0 * p.l) * xp.sin(th) + 3.0 / (p.m * p.l**2) * u) * p.dt
    newthdot = xp.clip(newthdot, -p.max_speed, p.max_speed)
    newth = th + newthdot * p.dt
    return xp.stack((newth, newthdot), axis=-1)


def cost(xp, state, u, p: PendulumParams):
    """The quadratic swing-up cost of applying ``u`` in ``state``."""
    th = state[..., 0]
    thdot = state[..., 1]
    return angle_normalize(xp, th) ** 2 + 0.1 * thdot**2 + 0.001 * (u**2)


def observe(xp, state):
    """``[cos θ, sin θ, θ']`` observation."""
    th = state[..., 0]
    thdot = state[..., 1]
    return xp.stack((xp.cos(th), xp.sin(th), thdot), axis=-1)
