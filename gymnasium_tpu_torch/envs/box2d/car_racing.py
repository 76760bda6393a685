"""CarRacing: random-track top-down racing with 96x96 pixel observations,
the host env class behind ``make("CarRacing-v3")``.

Counterpart of the JAX package's ``envs/box2d/car_racing.py``, which is plain
numpy in float64 and calls no JAX: the same code over the port's own ``Env``,
spaces, errors, canvas and display. API parity with reference
box2d/car_racing.py:1-850 (continuous + discrete actions,
lap_complete_percent, domain_randomize). Track generation follows the
reference's checkpoint/turn-rate algorithm; the car is the host model in
car_dynamics.py; observations rasterize through the numpy canvas (no
pygame/opencv on the path). It runs on the host and takes no device.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np

from gymnasium_tpu_torch import error, logger, spaces
from gymnasium_tpu_torch.core import Env
from gymnasium_tpu_torch.envs.box2d.car_dynamics import Car
from gymnasium_tpu_torch.utils.ezpickle import EzPickle

__all__ = ["CarRacing"]

STATE_W = 96
STATE_H = 96
VIDEO_W = 600
VIDEO_H = 400

SCALE = 6.0
TRACK_RAD = 900 / SCALE
PLAYFIELD = 2000 / SCALE
FPS = 50
ZOOM = 2.7

TRACK_DETAIL_STEP = 21 / SCALE
TRACK_TURN_RATE = 0.31
TRACK_WIDTH = 40 / SCALE
BORDER = 8 / SCALE
BORDER_MIN_COUNT = 4
GRASS_DIM = PLAYFIELD / 20.0

ROAD_COLOR = np.array([102, 102, 102])


class CarRacing(Env, EzPickle):
    """Race a car around a randomly generated closed track."""

    metadata = {"render_modes": ["human", "rgb_array", "state_pixels"], "render_fps": FPS}

    def __init__(
        self,
        render_mode: str | None = None,
        verbose: bool = False,
        lap_complete_percent: float = 0.95,
        domain_randomize: bool = False,
        continuous: bool = True,
    ):
        EzPickle.__init__(
            self, render_mode, verbose, lap_complete_percent, domain_randomize, continuous
        )
        self.continuous = continuous
        self.domain_randomize = domain_randomize
        self.lap_complete_percent = lap_complete_percent
        self.verbose = verbose
        self.render_mode = render_mode
        self._display = None

        if self.continuous:
            self.action_space = spaces.Box(
                np.array([-1, 0, 0]).astype(np.float32),
                np.array([+1, +1, +1]).astype(np.float32),
            )  # steer, gas, brake
        else:
            self.action_space = spaces.Discrete(5)  # noop, left, right, gas, brake

        self.observation_space = spaces.Box(
            low=0, high=255, shape=(STATE_H, STATE_W, 3), dtype=np.uint8
        )

        self.car: Car | None = None
        self.track: list | None = None
        self.reward = 0.0
        self.prev_reward = 0.0
        self.tile_visited_count = 0
        self.t = 0.0
        self.new_lap = False

        self._init_colors()

    def _init_colors(self):
        self.road_color = ROAD_COLOR.copy()
        self.bg_color = np.array([102, 204, 102])
        self.grass_color = np.array([102, 230, 102])

    def _randomize_colors(self):
        self.road_color = self.np_random.uniform(0, 210, size=3)
        self.bg_color = self.np_random.uniform(0, 210, size=3)
        self.grass_color = np.copy(self.bg_color)
        idx = self.np_random.integers(3)
        self.grass_color[idx] += 20

    # -- track generation (reference car_racing.py:306-470) ---------------

    def _create_track(self) -> bool:
        checkpoints = []
        CHECKPOINTS = 12
        for c in range(CHECKPOINTS):
            noise = self.np_random.uniform(0, 2 * math.pi * 1 / CHECKPOINTS)
            alpha = 2 * math.pi * c / CHECKPOINTS + noise
            rad = self.np_random.uniform(TRACK_RAD / 3, TRACK_RAD)
            if c == 0:
                alpha = 0
                rad = 1.5 * TRACK_RAD
            if c == CHECKPOINTS - 1:
                alpha = 2 * math.pi * c / CHECKPOINTS
                self.start_alpha = 2 * math.pi * (-0.5) / CHECKPOINTS
                rad = 1.5 * TRACK_RAD
            checkpoints.append((alpha, rad * math.cos(alpha), rad * math.sin(alpha)))

        x, y, beta = 1.5 * TRACK_RAD, 0.0, 0.0
        dest_i = 0
        laps = 0
        track = []
        no_freeze = 2500
        visited_other_side = False
        while True:
            alpha = math.atan2(y, x)
            if visited_other_side and alpha > 0:
                laps += 1
                visited_other_side = False
            if alpha < 0:
                visited_other_side = True
                alpha += 2 * math.pi

            while True:
                failed = True
                while True:
                    dest_alpha, dest_x, dest_y = checkpoints[dest_i % len(checkpoints)]
                    if alpha <= dest_alpha:
                        failed = False
                        break
                    dest_i += 1
                    if dest_i % len(checkpoints) == 0:
                        break
                if not failed:
                    break
                alpha -= 2 * math.pi

            r1x, r1y = math.cos(beta), math.sin(beta)
            p1x, p1y = -r1y, r1x
            dest_dx, dest_dy = dest_x - x, dest_y - y
            proj = r1x * dest_dx + r1y * dest_dy
            while beta - alpha > 1.5 * math.pi:
                beta -= 2 * math.pi
            while beta - alpha < -1.5 * math.pi:
                beta += 2 * math.pi
            prev_beta = beta
            proj *= SCALE
            if proj > 0.3:
                beta -= min(TRACK_TURN_RATE, abs(0.001 * proj))
            if proj < -0.3:
                beta += min(TRACK_TURN_RATE, abs(0.001 * proj))
            x += p1x * TRACK_DETAIL_STEP
            y += p1y * TRACK_DETAIL_STEP
            track.append((alpha, prev_beta * 0.5 + beta * 0.5, x, y))
            if laps > 4:
                break
            no_freeze -= 1
            if no_freeze == 0:
                break

        # closed-loop extraction
        i1, i2 = -1, -1
        i = len(track)
        while True:
            i -= 1
            if i == 0:
                return False
            pass_through_start = (
                track[i][0] > self.start_alpha and track[i - 1][0] <= self.start_alpha
            )
            if pass_through_start and i2 == -1:
                i2 = i
            elif pass_through_start and i1 == -1:
                i1 = i
                break
        track = track[i1 : i2 - 1]
        if len(track) == 0:
            return False

        first_beta = track[0][1]
        first_perp_x = math.cos(first_beta)
        first_perp_y = math.sin(first_beta)
        well_glued_together = np.sqrt(
            np.square(first_perp_x * (track[0][2] - track[-1][2]))
            + np.square(first_perp_y * (track[0][3] - track[-1][3]))
        )
        if well_glued_together > TRACK_DETAIL_STEP:
            return False

        self.track = track
        centers = np.array([[t[2], t[3]] for t in track])
        betas = np.array([t[1] for t in track])
        self._tile_centers = centers
        self._tile_betas = betas
        self.tile_visited = np.zeros(len(track), dtype=bool)
        return True

    # -- geometry helpers --------------------------------------------------

    def _nearest_tile(self, x: float, y: float) -> tuple[int, float]:
        d2 = np.sum((self._tile_centers - np.array([x, y])) ** 2, axis=1)
        idx = int(np.argmin(d2))
        return idx, float(np.sqrt(d2[idx]))

    def _on_road(self, x: float, y: float) -> bool:
        _, dist = self._nearest_tile(x, y)
        return dist <= TRACK_WIDTH * 1.2

    # -- API ---------------------------------------------------------------

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if self.domain_randomize:
            randomize = True
            if options is not None and "randomize" in options:
                randomize = options["randomize"]
            if randomize:
                self._randomize_colors()

        self.reward = 0.0
        self.prev_reward = 0.0
        self.tile_visited_count = 0
        self.t = 0.0
        self.new_lap = False

        while True:
            success = self._create_track()
            if success:
                break
            if self.verbose:
                print("retry to generate track (normal if there are not many instances of this message)")

        beta0, x0, y0 = self.track[0][1], self.track[0][2], self.track[0][3]
        self.car = Car(beta0, x0, y0)

        if self.render_mode == "human":
            self.render()
        return self._render_state(), {}

    def step(self, action):
        assert self.car is not None
        if action is not None:
            if self.continuous:
                action = np.asarray(action, dtype=np.float64)
                self.car.steer(-float(action[0]))
                self.car.gas(float(action[1]))
                self.car.brake(float(action[2]))
            else:
                if not self.action_space.contains(action):
                    raise error.InvalidAction(
                        f"you passed the invalid action `{action}`. "
                        f"The supported action_space is `{self.action_space}`"
                    )
                self.car.steer(-0.6 * (action == 1) + 0.6 * (action == 2))
                self.car.gas(0.2 * (action == 3))
                self.car.brake(0.8 * (action == 4))

        self.car.step(1.0 / FPS, self._on_road)
        self.t += 1.0 / FPS

        step_reward = 0.0
        terminated = False
        truncated = False
        info = {}
        if action is not None:
            self.reward -= 0.1
            # The reference's FrictionDetector marks a tile when any WHEEL
            # begins contact with it (car_racing.py:93-130): four wheels can
            # straddle a tile boundary and mark two tiles in one step, and at
            # spawn the wheels mark the tiles directly under the car. A
            # hull-center-only visit undercounted ~1 tile per random episode
            # (4.3 SE below the real engine's return distribution).
            for wx, wy in self.car.wheel_positions():
                idx, dist = self._nearest_tile(wx, wy)
                if dist <= TRACK_WIDTH and not self.tile_visited[idx]:
                    self.tile_visited[idx] = True
                    self.tile_visited_count += 1
                    self.reward += 1000.0 / len(self.track)
                    if (
                        self.tile_visited_count / len(self.track)
                        > self.lap_complete_percent
                    ):
                        self.new_lap = True

            step_reward = self.reward - self.prev_reward
            self.prev_reward = self.reward
            if self.tile_visited_count == len(self.track) or self.new_lap:
                terminated = True
                info["lap_finished"] = True
            x, y = self.car.hull[0], self.car.hull[1]
            if abs(x) > PLAYFIELD or abs(y) > PLAYFIELD:
                terminated = True
                info["lap_finished"] = False
                step_reward = -100

        if self.render_mode == "human":
            self.render()
        return self._render_state(), step_reward, terminated, truncated, info

    # -- rendering ---------------------------------------------------------

    def _render_view(self, width: int, height: int, px_per_m: float) -> np.ndarray:
        """Top-down view centered ahead of the car, heading up."""
        from gymnasium_tpu_torch.utils.raster import Canvas

        canvas = Canvas(width, height, tuple(int(v) for v in self.bg_color))
        cx, cy, angle = self.car.hull[0], self.car.hull[1], self.car.hull[2]
        ca, sa = math.cos(-angle), math.sin(-angle)

        def world_to_view(wx, wy):
            dx, dy = wx - cx, wy - cy
            # rotate so car heading (+y rotated by angle) points up
            vx = dx * ca - dy * sa
            vy = dx * sa + dy * ca
            return width / 2 + vx * px_per_m, height * 0.75 - vy * px_per_m

        # grass checker tiles (coarse)
        g = GRASS_DIM
        k0x = int((cx - width / px_per_m) // g)
        k0y = int((cy - height / px_per_m) // g)
        for kx in range(k0x - 2, k0x + 8):
            for ky in range(k0y - 2, k0y + 8):
                if (kx + ky) % 2 == 0:
                    continue
                pts = [
                    world_to_view(kx * g, ky * g),
                    world_to_view((kx + 1) * g, ky * g),
                    world_to_view((kx + 1) * g, (ky + 1) * g),
                    world_to_view(kx * g, (ky + 1) * g),
                ]
                canvas.polygon(pts, tuple(int(v) for v in self.grass_color))

        # road tiles near the car
        centers = self._tile_centers
        betas = self._tile_betas
        n = len(centers)
        d2 = np.sum((centers - self.car.hull[:2]) ** 2, axis=1)
        near = np.where(d2 < (width / px_per_m * 1.5) ** 2)[0]
        for i in near:
            j = (i - 1) % n
            b1, b2 = betas[i], betas[j]
            x1, y1 = centers[i]
            x2, y2 = centers[j]
            quad = [
                world_to_view(x1 - TRACK_WIDTH * math.cos(b1), y1 - TRACK_WIDTH * math.sin(b1)),
                world_to_view(x1 + TRACK_WIDTH * math.cos(b1), y1 + TRACK_WIDTH * math.sin(b1)),
                world_to_view(x2 + TRACK_WIDTH * math.cos(b2), y2 + TRACK_WIDTH * math.sin(b2)),
                world_to_view(x2 - TRACK_WIDTH * math.cos(b2), y2 - TRACK_WIDTH * math.sin(b2)),
            ]
            color = self.road_color + (i % 3) * 3  # subtle tile shading
            canvas.polygon(quad, tuple(int(v) for v in np.clip(color, 0, 255)))

        # the car (red rectangle with heading up in view frame)
        car_w, car_h = 3.0, 5.0
        pts = []
        for bx, by in [(-car_w / 2, -car_h / 2), (car_w / 2, -car_h / 2), (car_w / 2, car_h / 2), (-car_w / 2, car_h / 2)]:
            wx = cx + bx * math.cos(angle) - by * math.sin(angle)
            wy = cy + bx * math.sin(angle) + by * math.cos(angle)
            pts.append(world_to_view(wx, wy))
        canvas.polygon(pts, (204, 0, 0))

        # bottom status bar: speed indicator
        speed = self.car.speed
        bar_h = max(int(height * 0.04), 2)
        canvas.polygon(
            [(0, height - bar_h), (width, height - bar_h), (width, height), (0, height)],
            (0, 0, 0),
        )
        bar_len = min(int(abs(speed) * 2), width // 3)
        if bar_len > 0:
            canvas.polygon(
                [
                    (width // 10, height - bar_h + 1),
                    (width // 10 + bar_len, height - bar_h + 1),
                    (width // 10 + bar_len, height - 1),
                    (width // 10, height - 1),
                ],
                (255, 255, 255),
            )
        return canvas.rgb_array()

    def _render_state(self) -> np.ndarray:
        return self._render_view(STATE_W, STATE_H, px_per_m=STATE_W / 30.0)

    def render(self):
        if self.render_mode is None:
            logger.warn("You are calling render method without specifying any render mode.")
            return None
        if self.render_mode == "state_pixels":
            return self._render_state()
        frame = self._render_view(VIDEO_W, VIDEO_H, px_per_m=ZOOM * SCALE / 2.2)
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(VIDEO_W, VIDEO_H, FPS, "CarRacing")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None
