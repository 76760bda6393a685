"""CarRacing-v3 as a batch-first functional env, its 96x96x3 pixels drawn on the device.

Counterpart of ``CarRacingFunctional`` in the JAX package's
``envs/box2d/car_racing_functional.py``, with the same divergences from
upstream Gymnasium: a fixed track of ``NUM_TILES`` points on a closed
Catmull-Rom spline through 12 random checkpoints, one rigid hull with
slip-based wheel friction, tiles marked by the wheel nearest to them, and
flat visuals (road colour, checkered grass, car rectangle, speed bar).

The reference gathers and compacts with one-hot matrix products, which are
exact in float32 on a CPU but not on a card that runs ``matmul`` in TF32.
Here they are what they compute: an index gather for the spline, an
exclusive ``cumsum`` of the in-view mask and a scatter into the
``RASTER_TILES`` slots for the rasterizer. The state is a dict of
``centers`` (N, 300, 2), ``betas`` (N, 300), ``visited`` (N, 300) bool,
``hull`` (N, 6) ``[x, y, angle, vx, vy, omega]``, ``steer_angle`` (N, 2),
``wheel_omega`` (N, 4), ``r`` (N,) and ``done`` (N,) bool, float32 but for
the bools. The host ``CarRacing`` class is ``envs/box2d/car_racing.py``.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.box2d.car_dynamics import (
    CAR_INERTIA,
    CAR_MASS,
    ENGINE_POWER,
    FRICTION_LIMIT,
    SIZE,
    WHEEL_MOMENT_OF_INERTIA,
    WHEELPOS,
)
from gymnasium_tpu_torch.functional import FuncEnv, tree_map
from gymnasium_tpu_torch.utils.draws import uniform_map

__all__ = ["CarRacingFunctional"]

# The host env's constants (upstream box2d/car_racing.py), which the JAX
# package keeps in its host ``car_racing.py``.
STATE_W = 96
STATE_H = 96
SCALE = 6.0
TRACK_RAD = 900 / SCALE
PLAYFIELD = 2000 / SCALE
FPS = 50
TRACK_WIDTH = 40 / SCALE
GRASS_DIM = PLAYFIELD / 20.0
ROAD_COLOR = np.array([102, 102, 102])

NUM_TILES = 300  # tile-visit reward is 1000 / NUM_TILES a tile
CHECKPOINTS = 12
# Slots for the tiles inside the view rectangle: only tiles within
# TRACK_WIDTH of the 30 x 30 m view can touch a pixel, and no reachable pose
# of a track holds more than RASTER_TILES of them (tests/test_torch_car_racing.py).
RASTER_TILES = 96
WHEEL_RAD = 27 * SIZE
PIXELS_PER_M = STATE_W / 30.0
# The colours of a frame; an observation pixel is one of them.
PALETTE = np.array(
    [[102, 230, 102], [102, 204, 102], ROAD_COLOR, [204, 0, 0], [0, 0, 0], [255, 255, 255]], np.uint8
)
GRASS_A, GRASS_B, ROAD, CAR, BAR, SPEED = range(len(PALETTE))
# A pixel this close to a road edge (|a2 - bt| in m^2) or to a checker line
# (in grass squares) may flip between two devices' sin, cos and divides.
EDGE_MARGIN = 1e-3


def _sq(x):
    return x * x


def _catmull_rom(pts: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Closed Catmull-Rom spline through ``pts`` (N, C, 2) at the parameters
    ``t`` (T,) in [0, C): (N, T, 2)."""
    c = pts.shape[1]
    i1 = torch.floor(t).to(torch.int64) % c
    u = (t - torch.floor(t))[:, None]
    p0, p1, p2, p3 = (pts[:, i] for i in ((i1 - 1) % c, i1, (i1 + 1) % c, (i1 + 2) % c))
    return 0.5 * (
        2 * p1
        + (-p0 + p2) * u
        + (2 * p0 - 5 * p1 + 4 * p2 - p3) * (u * u)
        + (-p0 + 3 * p1 - 3 * p2 + p3) * (u * (u * u))
    )


@functools.lru_cache(maxsize=1)
def _tables() -> dict[str, torch.Tensor]:
    """The fixed tables, made once on the CPU, so that every device reads
    the same bits: the wheels' float32 positions times ``SIZE`` (as the
    reference rounds them), the pixel grid in the view frame (metres), the
    checkpoints' base angles, the tiles' spline parameters, the palette and the overlay codes (car
    rectangle and status-bar rows; -1 elsewhere)."""
    f32 = dict(dtype=torch.float32)
    px, py = torch.arange(STATE_W, **f32), torch.arange(STATE_H, **f32)
    view_x, view_y = (px - STATE_W / 2) / PIXELS_PER_M, (STATE_H * 0.75 - py) / PIXELS_PER_M
    car = (torch.abs(view_x)[None, :] <= 1.5) & (torch.abs(view_y)[:, None] <= 2.5)
    bar = (py >= STATE_H - 4)[:, None].expand(STATE_H, STATE_W)
    return {
        "wheel_local": torch.tensor(WHEELPOS, **f32) * SIZE,
        "px": px,
        "view_x": view_x,
        "view_y": view_y,
        "checkpoint_angle": 2 * math.pi * torch.arange(CHECKPOINTS, **f32) / CHECKPOINTS,
        "tile_t": torch.arange(NUM_TILES, **f32) * (CHECKPOINTS / NUM_TILES),
        "palette": torch.tensor(PALETTE, dtype=torch.uint8),
        "overlay": torch.where(bar, BAR, torch.where(car, CAR, -1)),
    }


class CarRacingFunctional(FuncEnv):
    """Stateless CarRacing with on-device pixel rendering.

    Options: ``continuous`` (default True: Box actions ``[steer, gas,
    brake]``; else ``Discrete(5)``: noop, left, right, gas, brake) and
    ``lap_complete_percent`` (0.95).
    """

    continuous = True

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        if "continuous" in options:
            self.continuous = bool(options.pop("continuous"))
        self.lap_complete_percent = float(options.pop("lap_complete_percent", 0.95))
        super().__init__(options)
        self.observation_space = spaces.Box(0, 255, (STATE_H, STATE_W, 3), np.uint8)
        if self.continuous:
            self.action_space = spaces.Box(
                np.array([-1.0, 0.0, 0.0], np.float32), np.array([1.0, 1.0, 1.0], np.float32), dtype=np.float32
            )
        else:
            self.action_space = spaces.Discrete(5)
        self._constants: dict = {}

    def _constant(self, name: str, device: torch.device) -> torch.Tensor:
        """A fixed table of :func:`_tables` on ``device``, copied there once:
        a copy from the host at every step would wait for the card."""
        key = (name, device)
        if key not in self._constants:
            self._constants[key] = _tables()[name].to(device)
        return self._constants[key]

    # -- reset ---------------------------------------------------------------

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: U[0, 1) (n, 2, CHECKPOINTS), the
        checkpoints' angle noise and radii."""
        return (torch.rand((n, 2, CHECKPOINTS), generator=rng, device=rng.device),)

    def reset_values(self, u: torch.Tensor, params: Any = None) -> dict:
        """The reset state of draws ``u`` (N, 2, CHECKPOINTS): checkpoint
        angles ``2 pi i / 12 + U[0, 2 pi / 12)`` and radii
        ``U[TRACK_RAD / 3, TRACK_RAD)``, the first and last pinned as the
        reference pins them, then the spline through them, the tiles'
        headings and the car on the first tile."""
        n, dev = u.shape[0], u.device
        alpha = self._constant("checkpoint_angle", dev) + uniform_map(u[:, 0], 0.0, 2 * math.pi / CHECKPOINTS)
        rad = uniform_map(u[:, 1], TRACK_RAD / 3, TRACK_RAD)
        alpha[:, 0], alpha[:, -1] = 0.0, 2 * math.pi * (CHECKPOINTS - 1) / CHECKPOINTS
        rad[:, 0], rad[:, -1] = 1.5 * TRACK_RAD, 1.5 * TRACK_RAD
        pts = torch.stack([rad * torch.cos(alpha), rad * torch.sin(alpha)], dim=-1)

        centers = _catmull_rom(pts, self._constant("tile_t", dev))
        tangent = torch.roll(centers, -1, dims=1) - centers
        # heading beta, travelling along (-sin beta, cos beta)
        betas = torch.atan2(-tangent[..., 0], tangent[..., 1])
        f32 = dict(dtype=torch.float32, device=dev)
        return {
            "centers": centers,
            "betas": betas,
            "visited": torch.zeros((n, NUM_TILES), dtype=torch.bool, device=dev),
            "hull": torch.cat([centers[:, 0], betas[:, 0:1], torch.zeros((n, 3), **f32)], dim=1),
            "steer_angle": torch.zeros((n, 2), **f32),
            "wheel_omega": torch.zeros((n, 4), **f32),
            "r": torch.zeros(n, **f32),
            "done": torch.zeros(n, dtype=torch.bool, device=dev),
        }

    def initial(self, rng: torch.Generator, params: Any = None):
        return tree_map(lambda x: x[0], self.initial_batched(rng, 1, params))

    def initial_batched(self, rng: torch.Generator, n: int, params: Any = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    # -- dynamics --------------------------------------------------------------

    def _controls(self, action):
        """``(steer target, gas, brake)``, each (N,)."""
        if self.continuous:
            a = action.to(torch.float32)
            return -a[:, 0], torch.clamp(a[:, 1], 0.0, 1.0), torch.clamp(a[:, 2], 0.0, 1.0)
        a = action.reshape(-1)
        return -0.6 * (a == 1) + 0.6 * (a == 2), 0.2 * (a == 3), 0.8 * (a == 4)

    def transition(self, state, action, rng, params: Any = None):
        steer_t, gas, brake = self._controls(action)
        dt = 1.0 / FPS
        hull = state["hull"]
        x, y, angle, vx, vy, omega_b = hull.unbind(1)
        c, s = torch.cos(angle)[:, None], torch.sin(angle)[:, None]

        wheel_local = self._constant("wheel_local", hull.device)  # (4, 2)
        rx = wheel_local[:, 0] * c - wheel_local[:, 1] * s
        ry = wheel_local[:, 0] * s + wheel_local[:, 1] * c

        # steering servo (front wheels only)
        diff = steer_t[:, None] - state["steer_angle"]
        speed = torch.sign(diff) * torch.clamp(50.0 * torch.abs(diff), max=3.0)
        steer_angle = torch.clamp(state["steer_angle"] + speed * dt, -0.4, 0.4)
        wheel_angle = angle[:, None] + torch.cat([steer_angle, torch.zeros_like(steer_angle)], dim=1)

        wvx = vx[:, None] - omega_b[:, None] * ry
        wvy = vy[:, None] + omega_b[:, None] * rx
        wc, ws = torch.cos(wheel_angle), torch.sin(wheel_angle)
        vf = -ws * wvx + wc * wvy  # forward speed a wheel
        vs = wc * wvx + ws * wvy  # side speed a wheel

        # grip from the nearest tile centre, and the tile each wheel marks
        centers = state["centers"]
        wpx, wpy = x[:, None] + rx, y[:, None] + ry
        d2 = _sq(wpx[:, :, None] - centers[:, None, :, 0]) + _sq(wpy[:, :, None] - centers[:, None, :, 1])
        nearest, idxw = torch.min(d2, dim=2)  # (N, 4); the first of equal minima, as jnp.argmin
        on_road = nearest <= (TRACK_WIDTH * 1.2) ** 2
        friction_limit = FRICTION_LIMIT * torch.where(on_road, 1.0, 0.6)

        wheel_omega = state["wheel_omega"]
        gas_w = torch.cat([torch.zeros_like(steer_angle), gas[:, None].expand(-1, 2)], dim=1)
        wheel_omega = wheel_omega + dt * ENGINE_POWER * gas_w / (
            WHEEL_MOMENT_OF_INERTIA * (torch.abs(wheel_omega) + 5.0)
        )
        # brakes: a hard lock at >= 0.9, else a decay
        brake = brake[:, None]
        val = torch.minimum(15.0 * brake, torch.abs(wheel_omega))
        wheel_omega = torch.where(
            brake >= 0.9, torch.zeros_like(wheel_omega), wheel_omega - torch.sign(wheel_omega) * val * (brake > 0)
        )

        vr = wheel_omega * WHEEL_RAD
        f_force = (-vf + vr) * 205000 * SIZE * SIZE
        p_force = -vs * 205000 * SIZE * SIZE
        force = torch.sqrt(_sq(f_force) + _sq(p_force)) + 1e-12
        scale = torch.clamp(friction_limit / force, max=1.0)
        f_force = f_force * scale
        p_force = p_force * scale
        wheel_omega = wheel_omega - dt * f_force * WHEEL_RAD / WHEEL_MOMENT_OF_INERTIA

        fx = p_force * wc + f_force * (-ws)
        fy = p_force * ws + f_force * wc
        fx_t, fy_t = torch.sum(fx, dim=1), torch.sum(fy, dim=1)
        torque = torch.sum(rx * fy - ry * fx, dim=1)

        vx = vx + fx_t / CAR_MASS * dt
        vy = vy + fy_t / CAR_MASS * dt
        omega_b = omega_b + torque / CAR_INERTIA * dt
        x = x + vx * dt
        y = y + vy * dt
        angle = angle + omega_b * dt

        # tile visits and reward: each wheel marks its nearest tile when on it
        tiles = torch.arange(NUM_TILES, device=hull.device)
        marks = torch.any((idxw[:, :, None] == tiles) & (nearest <= TRACK_WIDTH**2)[:, :, None], dim=1)
        newly = marks & ~state["visited"]
        visited = state["visited"] | marks
        count = torch.sum(visited, dim=1)
        step_reward = -0.1 + torch.sum(newly, dim=1) * (1000.0 / NUM_TILES)

        off_field = (torch.abs(x) > PLAYFIELD) | (torch.abs(y) > PLAYFIELD)
        lap_done = count >= self.lap_complete_percent * NUM_TILES
        step_reward = torch.where(off_field, -100.0, step_reward)
        return {
            "centers": centers,
            "betas": state["betas"],
            "visited": visited,
            "hull": torch.stack([x, y, angle, vx, vy, omega_b], dim=1),
            "steer_angle": steer_angle,
            "wheel_omega": wheel_omega,
            "r": step_reward,
            "done": off_field | lap_done,
        }

    def reward(self, state, action, next_state, rng, params: Any = None):
        return next_state["r"]

    def terminal(self, state, rng, params: Any = None):
        return state["done"]

    # -- rasterizer ------------------------------------------------------------

    def view_tiles(self, state):
        """The tile centres in the car frame, ``(tx, ty)`` (N, NUM_TILES)
        each, and which of them lie within ``TRACK_WIDTH`` (padded by 0.1 %)
        of the view rectangle: only those can touch a pixel."""
        hull = state["hull"]
        ca, sa = torch.cos(hull[:, 2])[:, None], torch.sin(hull[:, 2])[:, None]
        rel = state["centers"] - hull[:, None, :2]
        tx = rel[..., 0] * ca + rel[..., 1] * sa
        ty = -rel[..., 0] * sa + rel[..., 1] * ca
        margin = TRACK_WIDTH * 1.001
        in_rect = (torch.abs(tx) <= 15.0 + margin) & (ty >= -7.5 - margin) & (ty <= 22.5 + margin)
        return tx, ty, in_rect

    def _slot_tiles(self, state):
        """The in-view tiles packed into ``RASTER_TILES`` slots in tile order,
        ``(tx, ty)`` (N, RASTER_TILES) each; an empty slot lies at 1e6 m,
        where it can never win. A tile's slot is the count of in-view
        tiles before it (an exclusive ``cumsum``); tiles past the last slot
        would be dropped, and no reachable pose has any."""
        tx, ty, in_rect = self.view_tiles(state)
        counted = torch.cumsum(in_rect.to(torch.int32), dim=1)
        slot = torch.where(in_rect & (counted <= RASTER_TILES), counted - 1, RASTER_TILES).to(torch.int64)
        empty = torch.full((tx.shape[0], RASTER_TILES + 1), 1e6, dtype=torch.float32, device=tx.device)
        # the extra last slot takes every tile out of view, and is cut off
        return tuple(empty.scatter(1, slot, t)[:, :RASTER_TILES] for t in (tx, ty))

    def _road_terms(self, tx, ty):
        """``a2`` (N, K, W) and ``bt`` (N, K, H) of tiles ``(tx, ty)`` (N, K):
        a pixel (r, c) is on tile k's road where ``a2[k, c] <= bt[k, r]``.
        In the car frame the pixel grid is fixed and axis-aligned, so the
        squared distance separates into a column and a row term."""
        dev = tx.device
        a2 = _sq(self._constant("view_x", dev)[None, None, :] - tx[:, :, None])
        bt = TRACK_WIDTH**2 - _sq(self._constant("view_y", dev)[None, None, :] - ty[:, :, None])
        return a2, bt

    def road_mask(self, state) -> torch.Tensor:
        """(N, H, W) bool: the pixels within ``TRACK_WIDTH`` of a tile centre."""
        a2, bt = self._road_terms(*self._slot_tiles(state))
        return torch.any(a2[:, :, None, :] <= bt[:, :, :, None], dim=1)

    def _world_grid(self, state):
        """Each pixel's world coordinates ``(wx, wy)`` (N, H, W)."""
        hull = state["hull"]
        dev = hull.device
        ca, sa = torch.cos(hull[:, 2])[:, None, None], torch.sin(hull[:, 2])[:, None, None]
        vx = self._constant("view_x", dev)[None, None, :]
        vy = self._constant("view_y", dev)[None, :, None]
        cx, cy = hull[:, 0, None, None], hull[:, 1, None, None]
        return cx + vx * ca - vy * sa, cy + vx * sa + vy * ca

    def edge_pixels(self, state, margin: float = EDGE_MARGIN) -> torch.Tensor:
        """(N, H, W) bool: pixels whose road test lies within ``margin`` of
        its threshold for some in-view tile, or whose grass square lies
        within ``margin`` of a checker line. Tiles out of view miss every
        pixel by more than 0.09 m^2."""
        tx, ty, in_rect = self.view_tiles(state)
        near = []
        for lo in range(0, tx.shape[0], 8):  # (8, NUM_TILES, H, W) at a time
            a2, bt = self._road_terms(tx[lo : lo + 8], ty[lo : lo + 8])
            gap = torch.abs(a2[:, :, None, :] - bt[:, :, :, None])
            gap = torch.where(in_rect[lo : lo + 8, :, None, None], gap, torch.inf)
            near.append(torch.amin(gap, dim=1) < margin)
        wx, wy = self._world_grid(state)
        line = [torch.abs(g / GRASS_DIM - torch.round(g / GRASS_DIM)) < margin for g in (wx, wy)]
        return torch.cat(near) | line[0] | line[1]

    def observation(self, state, rng=None, params: Any = None):
        hull = state["hull"]
        dev = hull.device
        wx, wy = self._world_grid(state)
        checker = torch.remainder(torch.floor(wx / GRASS_DIM) + torch.floor(wy / GRASS_DIM), 2) == 0
        code = torch.where(checker, GRASS_A, GRASS_B)
        code = torch.where(self.road_mask(state), ROAD, code)
        overlay = self._constant("overlay", dev)
        code = torch.where(overlay >= 0, overlay, code)
        # speed bar on the status rows
        speed = torch.sqrt(_sq(hull[:, 3]) + _sq(hull[:, 4]))
        bar_len = torch.clamp(torch.abs(speed) * 2.0, max=STATE_W / 3.0)
        px = self._constant("px", dev)
        in_bar = (px >= STATE_W / 10)[None, :] & (px[None, :] <= STATE_W / 10 + bar_len[:, None])
        code = torch.where((overlay == BAR) & in_bar[:, None, :], SPEED, code)
        return self._constant("palette", dev)[code]
