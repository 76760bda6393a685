"""LunarLander rigid-body dynamics (own torch copy of the JAX package's
``envs/dynamics/lunar_lander.py``).

The lander is the reference's 3-body system: a hull and two legs on
motor-driven revolute joints (``LEG_SPRING_TORQUE`` shock absorbers), stepped
by the planar (Box2D-class) solver, with engine impulses at the reference's
geometry and powers. Here the solver ticks run through the fused planar step
(:mod:`gymnasium_tpu_torch.ops.planar_step`): a generated CUDA kernel on the
card, its plain twin on the CPU. The rest of a step is written in torch, with
the JAX module's expressions in their order, so each float operation rounds
as it does there.

All functions broadcast over leading batch axes; random draws are passed in
explicitly.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import numpy as np
import torch

from gymnasium_tpu_torch.ops.planar_codegen import ChunkTerrain
from gymnasium_tpu_torch.ops.planar_step import FusedPlanarStep
from gymnasium_tpu_torch.physics.planar import BodySpec, ContactSpec, JointSpec, PlanarWorld

FPS = 50
SCALE = 30.0

MAIN_ENGINE_POWER = 13.0
SIDE_ENGINE_POWER = 0.6

INITIAL_RANDOM = 1000.0

LANDER_POLY = [(-14, +17), (-17, 0), (-17, -10), (+17, -10), (+17, 0), (+14, +17)]
LEG_AWAY = 20
LEG_DOWN = 18
LEG_W, LEG_H = 2, 8

SIDE_ENGINE_HEIGHT = 14.0
SIDE_ENGINE_AWAY = 12.0

VIEWPORT_W = 600
VIEWPORT_H = 400

W = VIEWPORT_W / SCALE  # world width in meters
H = VIEWPORT_H / SCALE  # world height in meters
CHUNKS = 11

HELIPAD_Y = H / 4


def _polygon_area_inertia(poly_px):
    """Area (m^2), centroid y (m), and unit-density second moment (m^4)
    about the body origin, from the standard polygon integrals."""
    pts = np.asarray(poly_px, dtype=np.float64) / SCALE
    x = pts[:, 0]
    y = pts[:, 1]
    x1 = np.roll(x, -1)
    y1 = np.roll(y, -1)
    cross = x * y1 - x1 * y
    signed_area = 0.5 * np.sum(cross)
    cy = np.sum((y + y1) * cross) / (6 * signed_area)
    area = abs(signed_area)
    inertia = np.abs(np.sum(cross * (x * x + x * x1 + x1 * x1 + y * y + y * y1 + y1 * y1))) / 12.0
    return float(area), float(cy), float(inertia)


_HULL_AREA, _HULL_CY, _HULL_I = _polygon_area_inertia(LANDER_POLY)
_HULL_DENSITY = 5.0
_LEG_DENSITY = 1.0
_LEG_AREA = (2 * LEG_W / SCALE) * (2 * LEG_H / SCALE)

LANDER_MASS = _HULL_DENSITY * _HULL_AREA + 2 * _LEG_DENSITY * _LEG_AREA

# Box2D rotates the hull about its centroid, _HULL_CY above the body origin;
# the legs' mass is lumped rigidly (rest pose below the hull) into the inertia.
_LEG_CY = -(LEG_DOWN + LEG_H) / SCALE  # leg box center (hanging rest pose)
COM_Y = _HULL_CY

_HULL_MASS = _HULL_DENSITY * _HULL_AREA
_LEG_MASS = _LEG_DENSITY * _LEG_AREA
_LEG_BOX_I = _LEG_MASS * ((2 * LEG_W / SCALE) ** 2 + (2 * LEG_H / SCALE) ** 2) / 12.0
LANDER_INERTIA = (
    _HULL_DENSITY * _HULL_I
    - _HULL_MASS * _HULL_CY**2  # hull inertia about its own centroid
    + 2 * (_LEG_BOX_I + _LEG_MASS * ((LEG_AWAY / SCALE) ** 2 + (_LEG_CY - COM_Y) ** 2))
)


class LunarParams(NamedTuple):
    """Dynamics parameters (plain scalars)."""

    gravity: Any = -10.0
    dt: Any = 1.0 / FPS
    mass: Any = LANDER_MASS
    inertia: Any = LANDER_INERTIA
    main_power: Any = MAIN_ENGINE_POWER
    side_power: Any = SIDE_ENGINE_POWER
    # sleep detection (Box2D-like)
    sleep_lin_vel: Any = 0.06
    sleep_ang_vel: Any = 0.06
    sleep_time: Any = 0.5
    # wind (off unless enable_wind)
    wind_power: Any = 15.0
    turbulence_power: Any = 1.5


def generate_terrain(uniform12: torch.Tensor) -> torch.Tensor:
    """Terrain chunk heights (..., CHUNKS) from CHUNKS + 1 U[0, 1) draws.

    The reference's map (lunar_lander.py:344-357): 12 raw heights, the
    helipad chunks pinned to H/4 before smoothing, then
    ``smooth_y[i] = 0.33 * (height[i-1] + height[i] + height[i+1])`` where
    ``height[-1]`` wraps to the final draw.
    """
    height = uniform12 * (H / 2)
    mid = CHUNKS // 2
    height[..., mid - 2 : mid + 3] = HELIPAD_Y  # a new tensor: the draws stay as they are
    prev = torch.cat([height[..., -1:], height[..., : CHUNKS - 1]], dim=-1)
    cur = height[..., :CHUNKS]
    nxt = height[..., 1 : CHUNKS + 1]
    return 0.33 * (prev + cur + nxt)


def engine_impulses(hull, m_power, s_direction, s_power, dispersion, params: LunarParams):
    """Linear and angular impulses of the main and side engines this tick.

    The reference's tip/side offset geometry (lunar_lander.py:522-580), with
    the particle recoil folded into the body impulse; torque arms are taken
    about the centre of mass, ``COM_Y`` above the body origin. ``hull``:
    (..., 6) planar body row ``[x, y, angle, vx, vy, w]``.
    """
    angle = hull[..., 2]
    tip_x = torch.sin(angle)
    tip_y = torch.cos(angle)
    side_x = -tip_y
    side_y = tip_x

    d0 = dispersion[..., 0] / SCALE
    d1 = dispersion[..., 1] / SCALE

    # main engine: thrust along -tip applied below the body
    ox_m = tip_x * (4 / SCALE + 2 * d0) + side_x * d1
    oy_m = -tip_y * (4 / SCALE + 2 * d0) - side_y * d1
    jx_m = -ox_m * params.main_power * m_power
    jy_m = -oy_m * params.main_power * m_power
    rx_m = ox_m + COM_Y * tip_x
    ry_m = oy_m - COM_Y * tip_y
    torque_m = rx_m * jy_m - ry_m * jx_m

    # side engines
    ox_s = tip_x * d0 + side_x * (3 * d1 + s_direction * SIDE_ENGINE_AWAY / SCALE)
    oy_s = -tip_y * d0 - side_y * (3 * d1 + s_direction * SIDE_ENGINE_AWAY / SCALE)
    jx_s = -ox_s * params.side_power * s_power
    jy_s = -oy_s * params.side_power * s_power
    rx_s = ox_s - tip_x * 17 / SCALE + COM_Y * tip_x
    ry_s = oy_s + tip_y * SIDE_ENGINE_HEIGHT / SCALE - COM_Y * tip_y
    torque_s = rx_s * jy_s - ry_s * jx_s

    jx = jx_m + jx_s
    jy = jy_m + jy_s
    torque = torque_m + torque_s
    return jx, jy, torque


# --- 3-body planar world: hull + two legs on motor-driven revolute joints --
_LEG_I = _LEG_BOX_I
# Box2D contact friction is sqrt(fixture_a * fixture_b); terrain fixtures
# carry friction 0.1, the hull 0.1, the legs the Box2D default 0.2.
_HULL_FRICTION = math.sqrt(0.1 * 0.1)
_LEG_FRICTION = math.sqrt(0.2 * 0.1)
LEG_SPRING_TORQUE = 40.0
_LEG_MOTOR_SPEED = 0.3

# body order: [hull, leg(i=-1), leg(i=+1)] (reference creation order)
_LEG_HALF_W = LEG_W / SCALE
_LEG_HALF_H = LEG_H / SCALE


def _hull_probe_pts():
    """Every LANDER_POLY vertex, relative to the hull COM."""
    pts = np.asarray(LANDER_POLY, dtype=np.float64) / SCALE
    pts = pts.copy()
    pts[:, 1] -= _HULL_CY
    return pts


def build_lander_world(gravity: float = -10.0, dt_substeps: int = 2) -> PlanarWorld:
    """Hull + 2 legs, joints, limits and motors per the reference's creation
    block (lunar_lander.py:406-443)."""
    bodies = BodySpec(
        inv_mass=np.array([1 / _HULL_MASS, 1 / _LEG_MASS, 1 / _LEG_MASS]),
        inv_inertia=np.array([1 / _HULL_I_COM, 1 / _LEG_I, 1 / _LEG_I]),
    )
    # hip anchors: hull local (0, 0) = origin = (0, -cy) from the hull COM;
    # leg local (i*LEG_AWAY, LEG_DOWN)/SCALE from the leg center
    joints = JointSpec(
        body_a=np.array([0, 0]),
        body_b=np.array([1, 2]),
        anchor_a=np.array([[0.0, -_HULL_CY], [0.0, -_HULL_CY]]),
        anchor_b=np.array(
            [
                [-LEG_AWAY / SCALE, LEG_DOWN / SCALE],
                [+LEG_AWAY / SCALE, LEG_DOWN / SCALE],
            ]
        ),
        lower=np.array([0.9 - 0.5, -0.9]),
        upper=np.array([0.9, -0.9 + 0.5]),
        ref_angle=np.zeros(2),
    )
    hull_pts = _hull_probe_pts()
    leg_corners = [
        [-_LEG_HALF_W, -_LEG_HALF_H],
        [+_LEG_HALF_W, -_LEG_HALF_H],
    ]
    contacts = ContactSpec(
        body=np.array([1, 1, 2, 2] + [0] * len(hull_pts)),
        point=np.array(leg_corners + leg_corners + hull_pts.tolist()),
        friction=np.array([_LEG_FRICTION] * 4 + [_HULL_FRICTION] * len(hull_pts)),
    )
    return PlanarWorld(
        bodies,
        joints,
        contacts,
        gravity=gravity,
        dt=1.0 / FPS / dt_substeps,
        velocity_iterations=8,
        position_iterations=4,
    )


_SUBSTEPS = 2
_HULL_I_COM = _HULL_DENSITY * _HULL_I - _HULL_MASS * _HULL_CY**2
N_CONTACTS = 4 + len(LANDER_POLY)


@functools.lru_cache(maxsize=8)
def _lander_world(gravity: float) -> PlanarWorld:
    """The world of one gravity value, made once."""
    return build_lander_world(float(gravity))


# motor arrays are step constants: the leg "springs" drive outward at
# ±0.3 rad/s against their limits with LEG_SPRING_TORQUE available
_MOTOR_SPEED = np.array([-_LEG_MOTOR_SPEED, +_LEG_MOTOR_SPEED])
_MOTOR_TORQUE = np.array([LEG_SPRING_TORQUE, LEG_SPRING_TORQUE])


@functools.lru_cache(maxsize=8)
def lander_step(gravity: float = -10.0) -> FusedPlanarStep:
    """The fused solver step of the lander world at ``gravity`` (both
    substeps of an env step), made once per gravity value. Its build name
    carries the gravity, so worlds that differ never share a library."""
    name = "lunar_lander_g" + repr(float(gravity)).replace("-", "m").replace(".", "p")
    return FusedPlanarStep(
        _lander_world(float(gravity)),
        ChunkTerrain(CHUNKS, W / (CHUNKS - 1)),
        (_MOTOR_SPEED, _MOTOR_TORQUE),
        substeps=_SUBSTEPS,
        name=name,
    )


def observe(bodies, leg1, leg2):
    """The 8-dim LunarLander observation (reference lunar_lander.py:600).

    ``bodies``: (..., 3, 6) planar rows ``[x, y, angle, vx, vy, omega]`` for
    [hull, leg_left, leg_right]. The reference reports the body origin; the
    hull row carries its COM, so translate back by the rotated COM offset.
    """
    hull = bodies[..., 0, :]
    angle = hull[..., 2]
    x = hull[..., 0] + _HULL_CY * torch.sin(angle)
    y = hull[..., 1] - _HULL_CY * torch.cos(angle)
    vx = hull[..., 3]
    vy = hull[..., 4]
    omega = hull[..., 5]
    return torch.stack(
        [
            (x - W / 2) / (W / 2),
            (y - (HELIPAD_Y + LEG_DOWN / SCALE)) / (H / 2),
            vx * (W / 2) / FPS,
            vy * (H / 2) / FPS,
            angle,
            20.0 * omega / FPS,
            leg1.to(hull.dtype),
            leg2.to(hull.dtype),
        ],
        dim=-1,
    )


def shaping(obs):
    """Potential function of the shaped reward (lunar_lander.py:637-655).
    ``x ** 2`` of the JAX source lowers to ``x * x``."""
    return (
        -100.0 * torch.sqrt(obs[..., 0] * obs[..., 0] + obs[..., 1] * obs[..., 1])
        - 100.0 * torch.sqrt(obs[..., 2] * obs[..., 2] + obs[..., 3] * obs[..., 3])
        - 100.0 * torch.abs(obs[..., 4])
        + 10.0 * obs[..., 6]
        + 10.0 * obs[..., 7]
    )


def initial_state_pre(terrain_uniform, force_uniform2, params: LunarParams) -> dict:
    """The creation-pose state dict before the reference's settle tick.

    ``terrain_uniform``: (..., CHUNKS + 1) U[0, 1) draws; ``force_uniform2``:
    (..., 2) U[-1, 1) draws for the initial kick (the reference applies
    U(-INITIAL_RANDOM, INITIAL_RANDOM) N to the hull for one tick). Bodies
    start in the reference's creation pose (lunar_lander.py:373-443): hull
    origin at (W/2, H), legs at ±LEG_AWAY with ±0.05 rad and their hip joints
    violated, for the position solver to assemble, as Box2D does.
    """
    terrain = generate_terrain(terrain_uniform)
    batch_shape = terrain_uniform.shape[:-1]
    dev = terrain_uniform.device
    zeros = torch.zeros(batch_shape, dtype=torch.float32, device=dev)
    kick = force_uniform2 * INITIAL_RANDOM
    vx = kick[..., 0] * params.dt / _HULL_MASS
    vy = kick[..., 1] * params.dt / _HULL_MASS
    hull = torch.stack([zeros + W / 2, zeros + H + _HULL_CY, zeros, vx, vy, zeros], dim=-1)
    legs = []
    for i in (-1.0, +1.0):
        legs.append(
            torch.stack(
                [zeros + W / 2 - i * LEG_AWAY / SCALE, zeros + H, zeros + i * 0.05, zeros, zeros, zeros],
                dim=-1,
            )
        )
    bodies = torch.stack([hull] + legs, dim=-2)
    no_contact = zeros > 1.0
    obs0 = observe(bodies, no_contact, no_contact)
    return {
        "body": bodies,
        "terrain": terrain,
        "leg1": no_contact,
        "leg2": no_contact,
        "done": no_contact,
        "sleep_timer": zeros,
        "prev_shaping": shaping(obs0),
        "r": zeros,
        # Box2D-style warm-start impulses: without them the hull:leg inertia
        # ratio stalls the velocity solver and the lander collapses through
        # its legs on touchdown
        "jimp": torch.zeros(batch_shape + (2, 5), dtype=torch.float32, device=dev),
        "cimp": torch.zeros(batch_shape + (N_CONTACTS, 2), dtype=torch.float32, device=dev),
    }


def engine_activation(action, continuous: bool):
    """Map an action to ``(m_power, s_direction, s_power)``.

    Continuous: ``action = [main, lateral]`` in [-1, 1]^2; main fires above 0
    at power 0.5..1.0, lateral fires when |a| > 0.5. Discrete: 0 noop,
    1 left, 2 main, 3 right.
    """
    if continuous:
        a_main = action[..., 0]
        a_side = action[..., 1]
        main_on = a_main > 0.0
        m_power = torch.where(main_on, (torch.clamp(a_main, 0.0, 1.0) + 1.0) * 0.5, 0.0)
        side_on = torch.abs(a_side) > 0.5
        s_direction = torch.where(side_on, torch.sign(a_side), 0.0)
        s_power = torch.where(side_on, torch.clamp(torch.abs(a_side), 0.5, 1.0), 0.0)
    else:
        m_power = torch.where(action == 2, 1.0, 0.0)
        s_direction = torch.where(action == 1, -1.0, torch.where(action == 3, 1.0, 0.0))
        s_power = torch.where((action == 1) | (action == 3), 1.0, 0.0)
    return m_power, s_direction, s_power


def engine_external(state, action, dispersion, wind, params: LunarParams, continuous: bool):
    """Engine activation and impulses, as per-body external force rows.

    Returns ``(external (..., 3, 3), m_power, s_power)``.
    """
    hull = state["body"][..., 0, :]
    m_power, s_direction, s_power = engine_activation(action, continuous)
    jx, jy, torque = engine_impulses(hull, m_power, s_direction, s_power, dispersion, params)

    # wind force + turbulence torque act on the hull (lunar_lander.py:470-510)
    jx = jx + wind[..., 0] * params.dt
    torque = torque + wind[..., 1] * params.dt

    # engine/wind impulses -> force on the hull across the substeps
    zeros = torch.zeros_like(jx)
    hull_force = torch.stack([jx / params.dt, jy / params.dt, torque / params.dt], dim=-1)
    leg_force = torch.stack([zeros, zeros, zeros], dim=-1)
    external = torch.stack([hull_force, leg_force, leg_force], dim=-2)
    return external, m_power, s_power


def finish_step(state, bodies, warm, flags, m_power, s_power, params: LunarParams) -> dict:
    """The tail of a step after the solver: contact flags to legs and crash,
    sleep detection, the shaped reward, and the next state dict."""
    leg1 = flags[..., 0] | flags[..., 1]
    leg2 = flags[..., 2] | flags[..., 3]
    hull_contact = flags[..., 4]
    for k in range(5, N_CONTACTS):
        hull_contact = hull_contact | flags[..., k]

    new_hull = bodies[..., 0, :]
    # sleep detection: at rest (on legs) for sleep_time seconds => landed
    lin_speed = torch.sqrt(new_hull[..., 3] * new_hull[..., 3] + new_hull[..., 4] * new_hull[..., 4])
    at_rest = (
        (lin_speed < params.sleep_lin_vel)
        & (torch.abs(new_hull[..., 5]) < params.sleep_ang_vel)
        & (leg1 | leg2)
    )
    sleep_timer = torch.where(at_rest, state["sleep_timer"] + params.dt, 0.0)
    asleep = sleep_timer >= params.sleep_time

    obs = observe(bodies, leg1, leg2)
    new_shaping = shaping(obs)
    reward = new_shaping - state["prev_shaping"]
    reward = reward - m_power * 0.30 - s_power * 0.03

    crashed = hull_contact | (torch.abs(obs[..., 0]) >= 1.0)
    terminated = crashed | asleep
    reward = torch.where(crashed, -100.0, torch.where(asleep, 100.0, reward))

    return {
        "body": bodies,
        "terrain": state["terrain"],
        "leg1": leg1,
        "leg2": leg2,
        "done": terminated,
        "sleep_timer": sleep_timer,
        "prev_shaping": new_shaping,
        "r": reward,
        "jimp": warm[0],
        "cimp": warm[1],
    }


def full_step(state, action, dispersion, wind, params: LunarParams, continuous: bool) -> dict:
    """One complete LunarLander tick: engines, both solver substeps in one
    call of the fused step, reward. ``dispersion``: (..., 2) U[-1, 1);
    ``wind``: (..., 2) wind and turbulence terms (zeros when wind is off)."""
    external, m_power, s_power = engine_external(state, action, dispersion, wind, params, continuous)
    bodies, jimp, cimp, flags = lander_step(float(params.gravity))(
        state["body"], external, state["terrain"], state["jimp"], state["cimp"]
    )
    return finish_step(state, bodies, (jimp, cimp), flags, m_power, s_power, params)
