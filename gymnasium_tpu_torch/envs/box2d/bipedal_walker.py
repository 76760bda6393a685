"""BipedalWalker-v3 and its hardcore variant as a batch-first functional env.

Counterpart of ``BipedalWalkerFunctional`` in the JAX package's
``envs/box2d/bipedal_walker.py``, over the port's planar engine: the hull and
two legs of two links each on four torque-controlled revolute joints, 19
ground probes, a 200-point heightfield, a 24-dim observation with 10 lidar
readings. The four solver ticks of an env step (12 velocity and 8 position
iterations each, the joints' position error pulled at most 0.2 m an
iteration) run in one launch of the planar kernel generated for the
walker's world (:func:`walker_solver`): motors from the action as per-env
inputs, the heightfield read by index, joint impulses starting from zero
each tick, contact impulses carried across ticks and env steps. The
heightfield of a reset comes from the hand-written terrain kernel
(:mod:`gymnasium_tpu_torch.ops.walker_terrain`). On the CPU both run their
plain twins.

The state is a dict of ``bodies`` (N, 5, 6) ``[x, y, angle, vx, vy, omega]``
of hull, thigh1, shank1, thigh2, shank2, ``terrain`` (N, 200), ``cimp``
(N, 19, 2), ``prev_shaping``, ``r`` (N,) in float32 and ``done`` (N,) bool.
The host ``BipedalWalker`` class and its rendering are not ported.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.error import Error
from gymnasium_tpu_torch.functional import FuncEnv, tree_map
from gymnasium_tpu_torch.ops.planar_codegen import Heightfield
from gymnasium_tpu_torch.ops.planar_step import FusedPlanarStep
from gymnasium_tpu_torch.ops.walker_terrain import walker_terrain
from gymnasium_tpu_torch.physics.planar import BodySpec, ContactSpec, JointSpec, PlanarWorld
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = [
    "BipedalWalkerFunctional",
    "BipedalWalkerHardcore",
    "build_world",
    "generate_terrain",
    "ground_height_fn",
    "initial_bodies",
    "lidar_scan",
    "observe_state",
    "walker_solver",
    "walker_step",
]

FPS = 50
SCALE = 30.0

MOTORS_TORQUE = 80.0
SPEED_HIP = 4.0
SPEED_KNEE = 6.0
LIDAR_RANGE = 160 / SCALE

INITIAL_RANDOM = 5.0

HULL_POLY = [(-30, +9), (+6, +9), (+34, +1), (+34, -8), (-30, -8)]
LEG_DOWN = -8 / SCALE
LEG_W, LEG_H = 8 / SCALE, 34 / SCALE

VIEWPORT_W = 600
VIEWPORT_H = 400

TERRAIN_STEP = 14 / SCALE
TERRAIN_LENGTH = 200
TERRAIN_HEIGHT = VIEWPORT_H / SCALE / 4
TERRAIN_GRASS = 10
TERRAIN_STARTPAD = 20
FRICTION = 2.5

N_LIDAR = 10
_LIDAR_SAMPLES = 24  # ray-march resolution against the heightfield

#: Step limits of BipedalWalker-v3 and of its hardcore variant.
MAX_EPISODE_STEPS = 1600
HARDCORE_MAX_EPISODE_STEPS = 2000


def _poly_props(poly_px, density):
    """mass, centroid, inertia-about-centroid of a polygon body."""
    pts = np.asarray(poly_px, dtype=np.float64) / SCALE
    x, y = pts[:, 0], pts[:, 1]
    x1, y1 = np.roll(x, -1), np.roll(y, -1)
    cross = x * y1 - x1 * y
    area = 0.5 * np.sum(cross)
    cx = np.sum((x + x1) * cross) / (6 * area)
    cy = np.sum((y + y1) * cross) / (6 * area)
    i_origin = np.sum(cross * (x * x + x * x1 + x1 * x1 + y * y + y * y1 + y1 * y1)) / 12.0
    area = abs(area)
    mass = density * area
    inertia = density * abs(i_origin) - mass * (cx * cx + cy * cy)
    return mass, (cx, cy), inertia


_HULL_MASS, _HULL_COM, _HULL_I = _poly_props(HULL_POLY, 5.0)


def _box_props(w, h, density):
    mass = density * w * h
    inertia = mass * (w * w + h * h) / 12.0
    return mass, inertia


_THIGH_MASS, _THIGH_I = _box_props(LEG_W, LEG_H, 1.0)
_SHANK_MASS, _SHANK_I = _box_props(0.8 * LEG_W, LEG_H, 1.0)

# Hip anchor relative to the hull's center of mass.
_HIP_ANCHOR_HULL = (0.0 - _HULL_COM[0], LEG_DOWN - _HULL_COM[1])


def build_world(dt_substeps: int = 4, iters: int = 12) -> PlanarWorld:
    """The 5-body walker world: hull, thigh1, shank1, thigh2, shank2.

    The probes: the shank feet (leg ground contact), the shanks' knee-end
    corners (frictionless: a guard against a shank folding through the
    ground), the hull's corners (a crash), then the thighs' corners. Contact
    friction mixes as Box2D does, ``sqrt(fixture_a * fixture_b)``: the
    terrain's ``FRICTION`` with the legs' 0.2 and the hull's 0.1.
    """
    inv_mass = np.array(
        [1 / _HULL_MASS, 1 / _THIGH_MASS, 1 / _SHANK_MASS, 1 / _THIGH_MASS, 1 / _SHANK_MASS]
    )
    inv_inertia = np.array([1 / _HULL_I, 1 / _THIGH_I, 1 / _SHANK_I, 1 / _THIGH_I, 1 / _SHANK_I])
    bodies = BodySpec(inv_mass=inv_mass, inv_inertia=inv_inertia)
    hip = [_HIP_ANCHOR_HULL[0], _HIP_ANCHOR_HULL[1]]
    joints = JointSpec(
        body_a=np.array([0, 1, 0, 3]),
        body_b=np.array([1, 2, 3, 4]),
        anchor_a=np.array([hip, [0.0, -LEG_H / 2], hip, [0.0, -LEG_H / 2]]),
        anchor_b=np.array([[0.0, LEG_H / 2]] * 4),
        lower=np.array([-0.8, -1.6, -0.8, -1.6]),
        upper=np.array([1.1, -0.1, 1.1, -0.1]),
        ref_angle=np.zeros(4),
    )
    foot, half = 0.4 * LEG_W, LEG_W / 2
    contacts = ContactSpec(
        body=np.array([2, 2, 4, 4, 2, 2, 4, 4, 0, 0, 0, 1, 1, 1, 1, 3, 3, 3, 3]),
        point=np.array(
            [[-foot, -LEG_H / 2], [+foot, -LEG_H / 2]] * 2
            + [[-foot, +LEG_H / 2], [+foot, +LEG_H / 2]] * 2
            + [
                [-30 / SCALE - _HULL_COM[0], -8 / SCALE - _HULL_COM[1]],
                [+34 / SCALE - _HULL_COM[0], -8 / SCALE - _HULL_COM[1]],
                [+6 / SCALE - _HULL_COM[0], +9 / SCALE - _HULL_COM[1]],
            ]
            + [[-half, -LEG_H / 2], [+half, -LEG_H / 2], [-half, +LEG_H / 2], [+half, +LEG_H / 2]] * 2
        ),
        friction=np.array(
            [math.sqrt(0.2 * FRICTION)] * 4
            + [0.0] * 4
            + [math.sqrt(0.1 * FRICTION)] * 3
            + [math.sqrt(0.2 * FRICTION)] * 8
        ),
    )
    return PlanarWorld(
        bodies, joints, contacts, gravity=-10.0, dt=1.0 / FPS / dt_substeps, velocity_iterations=iters
    )


# 12 velocity and 8 position iterations a tick, four ticks an env step, the
# joints' position error pulled at most 0.2 m an iteration (the JAX
# module's settings and its reasons).
_WORLD = build_world()._replace(position_iterations=8, joint_correction_clamp=0.2)
_SUBSTEPS = 4
N_CONTACTS = len(_WORLD.contacts.body)

_OBS_LOW = np.array(
    [-math.pi, -5.0, -5.0, -5.0, -math.pi, -5.0, -math.pi, -5.0, -0.0,
     -math.pi, -5.0, -math.pi, -5.0, -0.0] + [-1.0] * N_LIDAR
).astype(np.float32)
_OBS_HIGH = np.array(
    [math.pi, 5.0, 5.0, 5.0, math.pi, 5.0, math.pi, 5.0, 5.0,
     math.pi, 5.0, math.pi, 5.0, 5.0] + [1.0] * N_LIDAR
).astype(np.float32)


@functools.lru_cache(maxsize=1)
def walker_solver() -> FusedPlanarStep:
    """The walker's four solver ticks as one fused planar step, made once:
    per-env motors, the heightfield read by index, no joint impulses carried,
    no external force."""
    return FusedPlanarStep(
        _WORLD,
        Heightfield(TERRAIN_LENGTH, TERRAIN_STEP),
        motors=None,
        substeps=_SUBSTEPS,
        carry_joints=False,
        external=False,
        name="bipedal_walker",
    )


@functools.lru_cache(maxsize=32)
def _constant(values: tuple, device: torch.device) -> torch.Tensor:
    """A float32 tensor of ``values`` on ``device``, made once: a copy from
    the host on every step would wait for the device."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def generate_terrain(uniform_steps: torch.Tensor, obstacle_draws: torch.Tensor | None = None) -> torch.Tensor:
    """Heightfields (N, TERRAIN_LENGTH) of U[-1, 1) steps ``uniform_steps``
    (N, TERRAIN_LENGTH): the reference's smoothed random walk, with the
    hardcore stumps, stairs and pits of U[0, 1) ``obstacle_draws`` when
    given. The terrain kernel on the card, its twin on the CPU."""
    return walker_terrain(uniform_steps, obstacle_draws)


def ground_height_fn(terrain: torch.Tensor):
    """Heightfield lookup ``f(x) -> y`` over the walker terrain (N, L);
    ``x`` is (N, ...). The division by ``TERRAIN_STEP`` is by a tensor on
    the terrain's device, so it rounds once on the card too."""
    n = terrain.shape[0]
    step = _constant((TERRAIN_STEP,), terrain.device)[0]

    def f(x):
        xc = torch.clamp(torch.div(x, step), 0.0, TERRAIN_LENGTH - 1 - 1e-6)
        i0 = torch.floor(xc)
        frac = xc - i0
        idx = i0.long().reshape(n, -1)
        h0 = torch.gather(terrain, 1, idx).reshape(x.shape)
        h1 = torch.gather(terrain, 1, torch.clamp(idx + 1, max=TERRAIN_LENGTH - 1)).reshape(x.shape)
        return h0 + (h1 - h0) * frac

    return f


def initial_bodies(n: int, device=None) -> torch.Tensor:
    """The reference's creation pose (N, 5, 6): the walker standing with
    straight legs at -0.05 and +0.05 rad and the hip joints 0.53 m violated,
    for the position solver to assemble as Box2D does."""
    return _constant(_CREATION_POSE, torch.device(device or "cpu")).expand(n, -1, -1).clone()


def _creation_pose() -> tuple:
    """The creation pose's five body rows, in float64."""
    init_x = TERRAIN_STEP * TERRAIN_STARTPAD / 2
    init_y = TERRAIN_HEIGHT + 2 * LEG_H
    rows = [(init_x + _HULL_COM[0], init_y + _HULL_COM[1], 0.0, 0.0, 0.0, 0.0)]
    for ang in (-0.05, 0.05):  # reference creation order: leg i=-1 then +1
        thigh_y = init_y - LEG_H / 2 - LEG_DOWN
        shank_y = init_y - LEG_H * 3 / 2 - LEG_DOWN
        rows += [(init_x, thigh_y, ang, 0.0, 0.0, 0.0), (init_x, shank_y, ang, 0.0, 0.0, 0.0)]
    return tuple(rows)


_CREATION_POSE = _creation_pose()


@functools.lru_cache(maxsize=1)
def _lidar_tables():
    """The lidar's sample offsets (N_LIDAR, _LIDAR_SAMPLES) in x and y,
    ``dx * t`` folded in float64 and rounded once to float32 as JAX adds a
    numpy float64 scalar to a float32 array, and the fractions ``t``."""
    ts = np.linspace(0.0, 1.0, _LIDAR_SAMPLES)
    dx = np.array([math.sin(1.5 * i / 10.0) * LIDAR_RANGE for i in range(N_LIDAR)])
    dy = np.array([-math.cos(1.5 * i / 10.0) * LIDAR_RANGE for i in range(N_LIDAR)])
    f32 = np.float32
    return (
        tuple(map(tuple, (dx[:, None] * ts).astype(f32))),
        tuple(map(tuple, (dy[:, None] * ts).astype(f32))),
        tuple(ts.astype(f32)),
    )


def lidar_scan(hull_pos: torch.Tensor, terrain: torch.Tensor) -> torch.Tensor:
    """10 ray fractions (N, 10) against the heightfield from ``hull_pos``
    (N, 2): each ray's 24 sample points in one (N, 10, 24) tensor and one
    gathered lookup. The reference marches far to near, nearer hits
    overwriting: the reading is the smallest ``t`` whose point lies on or
    below the ground, else 1."""
    off_x, off_y, ts = _lidar_tables()
    dev = hull_pos.device
    px = hull_pos[:, 0, None, None] + _constant(off_x, dev)
    py = hull_pos[:, 1, None, None] + _constant(off_y, dev)
    below = py <= ground_height_fn(terrain)(px)
    return torch.where(below, _constant(ts, dev), 1.0).amin(dim=-1)


def observe_state(state: dict, leg1=None, leg2=None) -> torch.Tensor:
    """The 24-dim observation (N, 24) of a state dict. Leg contact flags may
    be passed from the solver; otherwise they come from the foot height
    against the terrain."""
    bodies = state["bodies"]
    terrain = state["terrain"]
    hull = bodies[:, 0, :]
    angle = hull[:, 2]
    j_angles = bodies[:, 1:5, 2] - torch.stack([angle, bodies[:, 1, 2], angle, bodies[:, 3, 2]], dim=-1)
    j_speeds = bodies[:, 1:5, 5] - torch.stack([hull[:, 5], bodies[:, 1, 5], hull[:, 5], bodies[:, 3, 5]], dim=-1)
    hull_x = hull[:, 0] - _HULL_COM[0]
    hull_y = hull[:, 1] - _HULL_COM[1]
    lidar = lidar_scan(torch.stack([hull_x, hull_y], dim=-1), terrain)
    if leg1 is None or leg2 is None:
        gh = ground_height_fn(terrain)
        leg1 = bodies[:, 2, 1] - LEG_H / 2 <= gh(bodies[:, 2, 0]) + 0.01
        leg2 = bodies[:, 4, 1] - LEG_H / 2 <= gh(bodies[:, 4, 0]) + 0.01
    head = torch.stack(
        [
            angle,
            2.0 * hull[:, 5] / FPS,
            0.3 * hull[:, 3] * (VIEWPORT_W / SCALE) / FPS,
            0.3 * hull[:, 4] * (VIEWPORT_H / SCALE) / FPS,
            j_angles[:, 0],
            j_speeds[:, 0] / SPEED_HIP,
            j_angles[:, 1] + 1.0,
            j_speeds[:, 1] / SPEED_KNEE,
            leg1.to(torch.float32),
            j_angles[:, 2],
            j_speeds[:, 2] / SPEED_HIP,
            j_angles[:, 3] + 1.0,
            j_speeds[:, 3] / SPEED_KNEE,
            leg2.to(torch.float32),
        ],
        dim=-1,
    )
    return torch.cat([head, lidar], dim=-1)


def walker_step(state: dict, action: torch.Tensor) -> dict:
    """One env tick: motors from the action, the four solver ticks in one
    call of :func:`walker_solver`, then reward and termination.

    The JAX ``walker_step`` also builds the whole observation and reads only
    its first entry, the hull angle, for the shaping; here the angle is read
    directly, with the same result, and no lidar runs.
    """
    bodies, terrain = state["bodies"], state["terrain"]
    a = torch.clamp(action.to(torch.float32), -1.0, 1.0)
    motor_speed = torch.sign(a) * _constant((SPEED_HIP, SPEED_KNEE, SPEED_HIP, SPEED_KNEE), a.device)
    motor_torque = MOTORS_TORQUE * torch.abs(a)
    bodies, _, cimp, flags = walker_solver()(
        bodies, None, terrain, None, state["cimp"], motor_speed, motor_torque
    )
    # the hull's probes end an episode; the leg flags of the reference's
    # lower-leg contact listener are the observation's, from the foot height
    hull_contact = flags[:, 8] | flags[:, 9] | flags[:, 10]
    hull = bodies[:, 0, :]
    hull_x = hull[:, 0] - _HULL_COM[0]
    # Reference shaping: 130 * pos.x / SCALE minus an upright-posture term
    shaping = 130.0 * hull_x / SCALE - 5.0 * torch.abs(hull[:, 2])
    reward = shaping - state["prev_shaping"]
    reward = reward - 0.00035 * MOTORS_TORQUE * torch.sum(torch.abs(a), dim=-1)
    crashed = hull_contact | (hull_x < 0)
    finished = hull_x > (TERRAIN_LENGTH - TERRAIN_GRASS) * TERRAIN_STEP
    return {
        "bodies": bodies,
        "terrain": terrain,
        "prev_shaping": shaping,
        "done": crashed | finished,
        "r": torch.where(crashed, -100.0, reward),
        "cimp": cimp,
    }


class BipedalWalkerFunctional(FuncEnv):
    """Stateless BipedalWalker on the planar engine; option ``hardcore``
    adds stumps, stairs and pits to the terrain."""

    hardcore = False

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        if "hardcore" in options:
            self.hardcore = bool(options.pop("hardcore"))
        super().__init__(options)
        self.observation_space = spaces.Box(_OBS_LOW, _OBS_HIGH)
        self.action_space = spaces.Box(-np.ones(4, np.float32), np.ones(4, np.float32))

    @property
    def max_episode_steps(self) -> int:
        """The step limit the JAX package registers for this variant."""
        return HARDCORE_MAX_EPISODE_STEPS if self.hardcore else MAX_EPISODE_STEPS

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The U[0, 1) draws of ``n`` resets: terrain steps (n, 200), obstacle
        draws (n, 200) and the kick (n,)."""
        draw = functools.partial(torch.rand, generator=rng, device=rng.device)
        return draw((n, TERRAIN_LENGTH)), draw((n, TERRAIN_LENGTH)), draw((n,))

    def reset_pre(self, terrain_u, obstacle_u, kick_u) -> dict:
        """The state before the reference's settle tick, of U[0, 1) draws:
        the terrain of U[-1, 1) steps (and, in hardcore mode, its obstacles),
        the creation pose, and the hull kicked by U[-5, 5) N applied for one
        frame, ``kick / _HULL_MASS / FPS`` in float32 in that order."""
        n, dev = terrain_u.shape[0], terrain_u.device
        terrain = generate_terrain(uniform_map(terrain_u, -1.0, 1.0), obstacle_u if self.hardcore else None)
        kick = uniform_map(kick_u, -INITIAL_RANDOM, INITIAL_RANDOM)
        bodies = initial_bodies(n, dev)
        bodies[:, 0, 3] = bodies[:, 0, 3] + kick / _HULL_MASS / FPS
        zeros = torch.zeros(n, dtype=torch.float32, device=dev)
        return {
            "bodies": bodies,
            "terrain": terrain,
            "prev_shaping": zeros,
            "done": zeros > 0.0,
            "r": zeros,
            "cimp": torch.zeros((n, N_CONTACTS, 2), dtype=torch.float32, device=dev),
        }

    def reset_values(self, terrain_u, obstacle_u, kick_u, params: Any = None) -> dict:
        """The reset state of the draws: :meth:`reset_pre`, then the
        reference's zero-action settle tick, whose post-tick shaping seeds
        ``prev_shaping``; its reward and termination are cleared."""
        state = self.reset_pre(terrain_u, obstacle_u, kick_u)
        state = walker_step(state, torch.zeros((terrain_u.shape[0], 4), dtype=torch.float32, device=terrain_u.device))
        state["r"] = torch.zeros_like(state["r"])
        state["done"] = torch.zeros_like(state["done"])
        return state

    def initial(self, rng: torch.Generator, params: Any = None):
        return tree_map(lambda x: x[0], self.initial_batched(rng, 1, params))

    def initial_batched(self, rng: torch.Generator, n: int, params: Any = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def transition(self, state, action, rng, params: Any = None):
        return walker_step(state, action)

    def observation(self, state, rng, params: Any = None):
        return observe_state(state)

    def reward(self, state, action, next_state, rng, params: Any = None):
        return next_state["r"]

    def terminal(self, state, rng, params: Any = None):
        return state["done"]


class BipedalWalkerHardcore:
    """Construction guard (reference box2d/bipedal_walker.py:774-781): the
    hardcore variant is ``BipedalWalkerFunctional({"hardcore": True})``."""

    def __init__(self):
        raise Error(
            "Error initializing BipedalWalkerHardcore Environment.\n"
            "Currently, we do not support initializing this mode of environment by calling the class directly.\n"
            "To use this environment, instead create it by specifying the hardcore keyword in gym.make, i.e.\n"
            'gym.make("BipedalWalker-v3", hardcore=True)'
        )
