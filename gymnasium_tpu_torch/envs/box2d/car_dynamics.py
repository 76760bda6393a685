"""Constants of the top-down car model that CarRacing's functional reads.

Counterpart of the JAX package's ``envs/box2d/car_dynamics.py``: the engine
power, wheel inertia, friction limit and wheel positions, and the hull's mass
and moment of inertia, computed from the same four hull polygons with the
same polygon mass properties. The host ``Car`` class is not ported.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "SIZE",
    "ENGINE_POWER",
    "WHEEL_MOMENT_OF_INERTIA",
    "FRICTION_LIMIT",
    "WHEEL_R",
    "WHEELPOS",
    "CAR_MASS",
    "CAR_COM",
    "CAR_INERTIA",
]

SIZE = 0.02
ENGINE_POWER = 100000000 * SIZE * SIZE
WHEEL_MOMENT_OF_INERTIA = 4000 * SIZE * SIZE
FRICTION_LIMIT = 1000000 * SIZE * SIZE
WHEEL_R = 27
WHEELPOS = [(-55, +80), (+55, +80), (-55, -82), (+55, -82)]

HULL_POLY1 = [(-60, +130), (+60, +130), (+60, +110), (-60, +110)]
HULL_POLY2 = [(-15, +120), (+15, +120), (+20, +20), (-20, 20)]
HULL_POLY3 = [
    (+25, +20), (+50, -10), (+50, -40), (+20, -90),
    (-20, -90), (-50, -40), (-50, -10), (-25, +20),
]
HULL_POLY4 = [(-50, -120), (+50, -120), (+50, -90), (-50, -90)]


def _poly_mass_props(polys, density=1.0):
    """Mass, centre of mass and moment of inertia about it of a union of
    polygons (model units scaled by ``SIZE``), in float64."""
    mass, cx_sum, cy_sum, inertia = 0.0, 0.0, 0.0, 0.0
    for poly in polys:
        pts = np.asarray(poly, dtype=np.float64) * SIZE
        x, y = pts[:, 0], pts[:, 1]
        x1, y1 = np.roll(x, -1), np.roll(y, -1)
        cross = x * y1 - x1 * y
        area = 0.5 * np.sum(cross)
        m = density * abs(area)
        if abs(area) < 1e-12:
            continue
        cx = np.sum((x + x1) * cross) / (6 * area)
        cy = np.sum((y + y1) * cross) / (6 * area)
        i_o = density * abs(
            np.sum(cross * (x * x + x * x1 + x1 * x1 + y * y + y * y1 + y1 * y1)) / 12.0
        )
        mass += m
        cx_sum += m * cx
        cy_sum += m * cy
        inertia += i_o
    com = (cx_sum / mass, cy_sum / mass)
    inertia_com = inertia - mass * (com[0] ** 2 + com[1] ** 2)
    return mass, com, inertia_com


CAR_MASS, CAR_COM, CAR_INERTIA = _poly_mass_props([HULL_POLY1, HULL_POLY2, HULL_POLY3, HULL_POLY4])
