"""CartPole dynamics (own copy of the JAX package's ``envs/dynamics/cartpole.py``).

Written once for any array namespace ``xp`` (numpy, torch): the functional env
calls :func:`integrate` with ``xp=torch`` and the fused rollout kernel's plain
twin reuses it, so both follow the same Florian cart-pole ODE (Gymnasium
classic_control/cartpole.py:163-195) with ``polemass_length = masspole * length``.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple


class CartPoleParams(NamedTuple):
    """Dynamics parameters of the Florian cart-pole ODE.

    A NamedTuple of plain floats, usable from numpy and torch code alike.
    The fused rollout kernel receives them rounded once to float32.
    """

    gravity: Any = 9.8
    masscart: Any = 1.0
    masspole: Any = 0.1
    length: Any = 0.5  # half the pole's length
    force_mag: Any = 10.0
    tau: Any = 0.02
    theta_threshold: Any = 12 * 2 * math.pi / 360
    x_threshold: Any = 2.4
    reset_bound: Any = 0.05


def accelerations(xp, x_dot, theta, theta_dot, force, p: CartPoleParams):
    """Cart and pole angular accelerations for the current state and force."""
    total_mass = p.masspole + p.masscart
    polemass_length = p.masspole * p.length
    costheta = xp.cos(theta)
    sintheta = xp.sin(theta)
    temp = (force + polemass_length * xp.square(theta_dot) * sintheta) / total_mass
    thetaacc = (p.gravity * sintheta - costheta * temp) / (
        p.length * (4.0 / 3.0 - p.masspole * xp.square(costheta) / total_mass)
    )
    xacc = temp - polemass_length * thetaacc * costheta / total_mass
    return xacc, thetaacc


def integrate(xp, state, force, p: CartPoleParams, euler: bool = True):
    """Advance ``state = [x, x_dot, theta, theta_dot]`` one ``tau`` tick.

    ``state`` may carry leading batch axes; the physics axis is the last one.
    ``euler=True`` is the explicit-Euler default; ``False`` selects
    semi-implicit Euler (velocity updated first), matching the reference's
    ``kinematics_integrator`` switch.
    """
    x = state[..., 0]
    x_dot = state[..., 1]
    theta = state[..., 2]
    theta_dot = state[..., 3]
    xacc, thetaacc = accelerations(xp, x_dot, theta, theta_dot, force, p)
    if euler:
        x = x + p.tau * x_dot
        x_dot = x_dot + p.tau * xacc
        theta = theta + p.tau * theta_dot
        theta_dot = theta_dot + p.tau * thetaacc
    else:
        x_dot = x_dot + p.tau * xacc
        x = x + p.tau * x_dot
        theta_dot = theta_dot + p.tau * thetaacc
        theta = theta + p.tau * theta_dot
    return xp.stack((x, x_dot, theta, theta_dot), axis=-1)


def is_terminated(xp, state, p: CartPoleParams):
    """Pole fell over or cart left the track."""
    x = state[..., 0]
    theta = state[..., 2]
    return (xp.abs(x) > p.x_threshold) | (xp.abs(theta) > p.theta_threshold)
