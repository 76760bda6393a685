"""The top-down car model: slip-based wheel friction on one rigid body.

Counterpart of the JAX package's ``envs/box2d/car_dynamics.py``: the engine
power, wheel inertia, friction limit and wheel positions, and the hull's mass
and moment of inertia, computed from the same four hull polygons with the
same polygon mass properties, which CarRacing's functional reads; and the
host :class:`Car` that the host ``CarRacing`` drives, plain numpy in float64
as the JAX class is.
"""

from __future__ import annotations

import math

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
    "Car",
]

SIZE = 0.02
ENGINE_POWER = 100000000 * SIZE * SIZE
WHEEL_MOMENT_OF_INERTIA = 4000 * SIZE * SIZE
FRICTION_LIMIT = 1000000 * SIZE * SIZE
WHEEL_R = 27
WHEEL_W = 14
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


class Car:
    """A drivable car: state is plain numpy, no physics-world dependency."""

    def __init__(self, init_angle: float, init_x: float, init_y: float):
        self.hull = np.array([init_x, init_y, init_angle, 0.0, 0.0, 0.0])
        self.wheel_omega = np.zeros(4)
        self.steer_angle = np.zeros(2)  # front wheel joint angles
        self.gas_val = 0.0
        self.brake_val = 0.0
        self.steer_target = 0.0
        self.fuel_spent = 0.0
        self.wheel_rad = np.array(
            [WHEEL_R * SIZE * 1.0, WHEEL_R * SIZE * 1.0, WHEEL_R * SIZE, WHEEL_R * SIZE]
        )
        self.phase = np.zeros(4)

    # -- controls ----------------------------------------------------------

    def gas(self, gas: float):
        """Rear-wheel throttle with gradual ramp-up."""
        gas = float(np.clip(gas, 0, 1))
        diff = gas - self.gas_val
        if diff > 0.1:
            diff = 0.1
        self.gas_val += diff

    def brake(self, b: float):
        """Brake all wheels; >=0.9 locks them."""
        self.brake_val = float(b)

    def steer(self, s: float):
        """Steering-wheel target position in [-1, 1]."""
        self.steer_target = float(s)

    # -- dynamics ----------------------------------------------------------

    def step(self, dt: float, on_road) -> None:
        """Advance the car; ``on_road(x, y) -> bool`` gives per-wheel grip."""
        x, y, angle, vx, vy, omega_b = self.hull
        c, s = math.cos(angle), math.sin(angle)

        fx_total, fy_total, torque_total = 0.0, 0.0, 0.0

        for i, (wx_px, wy_px) in enumerate(WHEELPOS):
            wx, wy = wx_px * SIZE, wy_px * SIZE
            # steering joint: first-order servo toward target, bounded speed
            if i < 2:
                diff = self.steer_target - self.steer_angle[i]
                speed = math.copysign(min(50.0 * abs(diff), 3.0), diff)
                self.steer_angle[i] = float(
                    np.clip(self.steer_angle[i] + speed * dt, -0.4, 0.4)
                )
                wheel_angle = angle + self.steer_angle[i]
            else:
                wheel_angle = angle

            # world position / velocity of the wheel
            rx = wx * c - wy * s
            ry = wx * s + wy * c
            wvx = vx - omega_b * ry
            wvy = vy + omega_b * rx

            wc, ws = math.cos(wheel_angle), math.sin(wheel_angle)
            forw = (-ws, wc)  # local +y
            side = (wc, ws)  # local +x
            vf = forw[0] * wvx + forw[1] * wvy
            vs = side[0] * wvx + side[1] * wvy

            friction_limit = FRICTION_LIMIT * (1.0 if on_road(x + rx, y + ry) else 0.6)

            gas_i = self.gas_val if i >= 2 else 0.0
            self.wheel_omega[i] += (
                dt * ENGINE_POWER * gas_i / WHEEL_MOMENT_OF_INERTIA / (abs(self.wheel_omega[i]) + 5.0)
            )
            self.fuel_spent += dt * ENGINE_POWER * gas_i

            if self.brake_val >= 0.9:
                self.wheel_omega[i] = 0.0
            elif self.brake_val > 0:
                val = 15.0 * self.brake_val
                if val > abs(self.wheel_omega[i]):
                    val = abs(self.wheel_omega[i])
                self.wheel_omega[i] -= math.copysign(val, self.wheel_omega[i])
            self.phase[i] += self.wheel_omega[i] * dt

            vr = self.wheel_omega[i] * self.wheel_rad[i]
            f_force = (-vf + vr) * 205000 * SIZE * SIZE
            p_force = -vs * 205000 * SIZE * SIZE
            force = math.sqrt(f_force**2 + p_force**2)

            if force > friction_limit:
                f_force *= friction_limit / force
                p_force *= friction_limit / force

            self.wheel_omega[i] -= dt * f_force * self.wheel_rad[i] / WHEEL_MOMENT_OF_INERTIA

            fx = p_force * side[0] + f_force * forw[0]
            fy = p_force * side[1] + f_force * forw[1]
            fx_total += fx
            fy_total += fy
            torque_total += rx * fy - ry * fx

        vx += fx_total / CAR_MASS * dt
        vy += fy_total / CAR_MASS * dt
        omega_b += torque_total / CAR_INERTIA * dt
        x += vx * dt
        y += vy * dt
        angle += omega_b * dt
        self.hull = np.array([x, y, angle, vx, vy, omega_b])

    @property
    def speed(self) -> float:
        """Hull speed magnitude."""
        return float(math.hypot(self.hull[3], self.hull[4]))

    def wheel_positions(self) -> np.ndarray:
        """World (x, y) of the four wheel centers, shape (4, 2).

        The reference attaches wheels as separate Box2D bodies; here they are
        rigid offsets of the hull (the revolute steering joint moves the
        wheel's heading, not its center)."""
        x, y, angle = self.hull[0], self.hull[1], self.hull[2]
        c, s = math.cos(angle), math.sin(angle)
        out = np.empty((4, 2))
        for i, (wx_px, wy_px) in enumerate(WHEELPOS):
            wx, wy = wx_px * SIZE, wy_px * SIZE
            out[i] = (x + wx * c - wy * s, y + wx * s + wy * c)
        return out
