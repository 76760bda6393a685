"""Mountain-car dynamics, discrete and continuous (own copy of the JAX
package's ``envs/dynamics/mountain_car.py``).

Written once for any array namespace ``xp`` (numpy, torch). Reference
classic_control/mountain_car.py:132-155 and continuous_mountain_car.py.
"""

from __future__ import annotations

from typing import Any, NamedTuple


class MountainCarParams(NamedTuple):
    """Parameters of the discrete-action mountain car."""

    min_position: Any = -1.2
    max_position: Any = 0.6
    max_speed: Any = 0.07
    goal_position: Any = 0.5
    goal_velocity: Any = 0.0
    force: Any = 0.001
    gravity: Any = 0.0025
    reset_low: Any = -0.6
    reset_high: Any = -0.4


class ContinuousMountainCarParams(NamedTuple):
    """Parameters of the continuous-action mountain car."""

    min_action: Any = -1.0
    max_action: Any = 1.0
    min_position: Any = -1.2
    max_position: Any = 0.6
    max_speed: Any = 0.07
    goal_position: Any = 0.45
    goal_velocity: Any = 0.0
    power: Any = 0.0015
    gravity: Any = 0.0025
    reset_low: Any = -0.6
    reset_high: Any = -0.4


def integrate(xp, state, push, p):
    """Advance ``[position, velocity]`` one tick given the applied ``push``
    (``(action-1)*force`` discrete, ``force*power`` continuous).

    The left wall is inelastic: hitting ``min_position`` zeroes velocity.
    """
    position = state[..., 0]
    velocity = state[..., 1]
    velocity = velocity + push - xp.cos(3 * position) * p.gravity
    velocity = xp.clip(velocity, -p.max_speed, p.max_speed)
    position = position + velocity
    position = xp.clip(position, p.min_position, p.max_position)
    velocity = xp.where((position <= p.min_position) & (velocity < 0), 0.0, velocity)
    return xp.stack((position, velocity), axis=-1)


def is_goal(xp, state, p):
    """Reached the flag with non-negative velocity."""
    return (state[..., 0] >= p.goal_position) & (state[..., 1] >= p.goal_velocity)
