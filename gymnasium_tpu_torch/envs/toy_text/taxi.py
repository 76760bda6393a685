"""Taxi: the host env class over the dense model (own copy of the JAX
package's ``envs/toy_text/taxi.py``).

Reference toy_text/taxi.py:278-440: the 500-state Dietterich taxi MDP with
``is_rainy`` perpendicular slips, ``fickle_passenger`` destination switches
and ``action_mask`` info entries. The env runs on the host in numpy and
takes no device.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularHostEnv, TabularModel, model_from_P
from gymnasium_tpu_torch.envs.toy_text.utils import categorical_sample

__all__ = ["LOCS", "MAP", "TaxiEnv", "build_taxi_model", "decode", "encode"]

MAP = [
    "+---------+",
    "|R: | : :G|",
    "| : | : : |",
    "| : : : : |",
    "| | : | : |",
    "|Y| : |B: |",
    "+---------+",
]

LOCS = [(0, 0), (0, 4), (4, 0), (4, 3)]

SOUTH, NORTH, EAST, WEST, PICKUP, DROPOFF = range(6)


def encode(taxi_row: int, taxi_col: int, pass_loc: int, dest_idx: int) -> int:
    """Pack (row, col, passenger, destination) into a state index."""
    return ((taxi_row * 5 + taxi_col) * 5 + pass_loc) * 4 + dest_idx


def decode(i: int):
    """Unpack a state index into (row, col, passenger, destination)."""
    dest_idx = i % 4
    i //= 4
    pass_loc = i % 5
    i //= 5
    taxi_col = i % 5
    i //= 5
    taxi_row = i
    if not 0 <= taxi_row < 5:
        raise ValueError(f"state index out of range: row {taxi_row}")
    return taxi_row, taxi_col, pass_loc, dest_idx


def build_taxi_model(is_rainy: bool = False) -> TabularModel:
    """Dense transition tensors for the 500-state taxi MDP."""
    desc = np.asarray(MAP, dtype="c")
    max_row, max_col = 4, 4
    n_states, n_actions = 500, 6

    def clamp(row, col, dr, dc):
        return max(0, min(row + dr, max_row)), max(0, min(col + dc, max_col))

    def can_move_east(row, col):
        return desc[1 + row, 2 * col + 2] == b":"

    def can_move_west(row, col):
        return desc[1 + row, 2 * col] == b":"

    def pickup(row, col, pass_idx):
        if pass_idx < 4 and (row, col) == LOCS[pass_idx]:
            return 4, -1
        return pass_idx, -10

    def dropoff(row, col, pass_idx, dest_idx):
        if (row, col) == LOCS[dest_idx] and pass_idx == 4:
            return dest_idx, 20, True
        if (row, col) in LOCS and pass_idx == 4:
            return LOCS.index((row, col)), -1, False
        return pass_idx, -10, False

    def slip_position(row, col, dr, dc, offset):
        nr, nc = clamp(row, col, dr, dc)
        if desc[1 + nr, 2 * nc + offset] == b":":
            return nr, nc
        return row, col

    # perpendicular slips: (intended, left-slip(+offset 2), right-slip)
    rainy_moves = {
        SOUTH: ((1, 0), (0, -1), (0, 1)),
        NORTH: ((-1, 0), (0, -1), (0, 1)),
        EAST: ((0, 1), (1, 0), (-1, 0)),
        WEST: ((0, -1), (1, 0), (-1, 0)),
    }
    moves = {SOUTH: (1, 0), NORTH: (-1, 0), EAST: (0, 1), WEST: (0, -1)}

    P: dict = {s: {a: [] for a in range(n_actions)} for s in range(n_states)}
    initial = np.zeros(n_states)

    for row in range(5):
        for col in range(5):
            for pass_idx in range(5):
                for dest_idx in range(4):
                    state = encode(row, col, pass_idx, dest_idx)
                    if pass_idx < 4 and pass_idx != dest_idx:
                        initial[state] += 1
                    for action in range(n_actions):
                        new_row, new_col, new_pass = row, col, pass_idx
                        reward, term = -1, False
                        movable = (
                            action in (SOUTH, NORTH)
                            or (action == EAST and can_move_east(row, col))
                            or (action == WEST and can_move_west(row, col))
                        )
                        if action <= WEST and movable:
                            dr, dc = rainy_moves[action][0] if is_rainy else moves[action]
                            new_row, new_col = clamp(row, col, dr, dc)
                        elif action == PICKUP:
                            new_pass, reward = pickup(row, col, pass_idx)
                        elif action == DROPOFF:
                            new_pass, reward, term = dropoff(row, col, pass_idx, dest_idx)
                        intended = encode(new_row, new_col, new_pass, dest_idx)

                        if is_rainy and action <= WEST:
                            # slips only apply when the intended move was legal
                            if movable:
                                lr, lc = slip_position(row, col, *rainy_moves[action][1], offset=2)
                                rr, rc = slip_position(row, col, *rainy_moves[action][2], offset=0)
                            else:
                                lr, lc = rr, rc = row, col
                            left = encode(lr, lc, new_pass, dest_idx)
                            right = encode(rr, rc, new_pass, dest_idx)
                            P[state][action].append((0.8, intended, -1, term))
                            P[state][action].append((0.1, left, -1, term))
                            P[state][action].append((0.1, right, -1, term))
                        else:
                            P[state][action].append((1.0, intended, reward, term))

    initial /= initial.sum()
    return model_from_P(P, initial)


class TaxiEnv(TabularHostEnv):
    """Pick up the passenger and drop them at their destination."""

    metadata = {"render_modes": ["human", "ansi", "rgb_array"], "render_fps": 4}

    def __init__(
        self,
        render_mode: str | None = None,
        is_rainy: bool = False,
        fickle_passenger: bool = False,
    ):
        self.desc = np.asarray(MAP, dtype="c")
        self.locs = LOCS
        self.is_rainy = is_rainy
        self.fickle_passenger = fickle_passenger
        self.fickle_step = False
        super().__init__(build_taxi_model(is_rainy), render_mode)

    def encode(self, taxi_row, taxi_col, pass_loc, dest_idx):
        """Pack components into a state index."""
        return encode(taxi_row, taxi_col, pass_loc, dest_idx)

    def decode(self, i):
        """Unpack a state index (iterator, parity with reference)."""
        return iter(decode(int(i)))

    def action_mask(self, state: int) -> np.ndarray:
        """Valid-action mask for ``state`` (reference taxi.py:371)."""
        mask = np.zeros(6, dtype=np.int8)
        taxi_row, taxi_col, pass_loc, dest_idx = decode(int(state))
        if taxi_row < 4:
            mask[SOUTH] = 1
        if taxi_row > 0:
            mask[NORTH] = 1
        if taxi_col < 4 and self.desc[taxi_row + 1, 2 * taxi_col + 2] == b":":
            mask[EAST] = 1
        if taxi_col > 0 and self.desc[taxi_row + 1, 2 * taxi_col] == b":":
            mask[WEST] = 1
        if pass_loc < 4 and (taxi_row, taxi_col) == self.locs[pass_loc]:
            mask[PICKUP] = 1
        if pass_loc == 4 and (
            (taxi_row, taxi_col) == self.locs[dest_idx] or (taxi_row, taxi_col) in self.locs
        ):
            mask[DROPOFF] = 1
        return mask

    def step(self, a):
        p, s, r, t = self._sample_transition(a)
        self.lastaction = a

        prev_row, prev_col, prev_pass, prev_dest = decode(int(self.s))
        taxi_row, taxi_col, pass_loc, _ = decode(int(s))

        # Fickle passenger: may change destination the first time the cab
        # moves with them aboard.
        if (
            self.fickle_passenger
            and self.fickle_step
            and prev_pass == 4
            and (taxi_row != prev_row or taxi_col != prev_col)
        ):
            self.fickle_step = False
            possible = [i for i in range(len(self.locs)) if i != prev_dest]
            dest_idx = self.np_random.choice(possible)
            s = encode(taxi_row, taxi_col, pass_loc, dest_idx)

        self.s = s
        if self.render_mode == "human":
            self.render()
        return int(s), r, t, False, {"prob": p, "action_mask": self.action_mask(s)}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super(TabularHostEnv, self).reset(seed=seed)
        self.s = int(categorical_sample(self.model.initial_probs, self.np_random))
        self.lastaction = None
        self.fickle_step = self.fickle_passenger and self.np_random.random() < 0.3
        if self.render_mode == "human":
            self.render()
        return int(self.s), {"prob": 1.0, "action_mask": self.action_mask(self.s)}

    def render(self):
        if self.render_mode is None:
            import gymnasium_tpu_torch.logger as logger

            logger.warn("You are calling render method without specifying any render mode.")
            return None
        if self.render_mode == "ansi":
            return self._render_text()
        return self._render_rgb()

    def _render_text(self) -> str:
        desc = [[c.decode("utf-8") for c in line] for line in self.desc.tolist()]
        taxi_row, taxi_col, pass_idx, dest_idx = decode(int(self.s))
        from gymnasium_tpu_torch.utils.colorize import colorize

        def highlight(row, col, color, hl=True):
            desc[1 + row][2 * col + 1] = colorize(desc[1 + row][2 * col + 1], color, highlight=hl)

        if pass_idx < 4:
            highlight(taxi_row, taxi_col, "yellow")
            pr, pc = self.locs[pass_idx]
            desc[1 + pr][2 * pc + 1] = colorize(desc[1 + pr][2 * pc + 1], "blue", bold=True)
        else:
            highlight(taxi_row, taxi_col, "green")
        dr, dc = self.locs[dest_idx]
        desc[1 + dr][2 * dc + 1] = colorize(desc[1 + dr][2 * dc + 1], "magenta")
        out = "\n".join("".join(row) for row in desc) + "\n"
        if self.lastaction is not None:
            out += f"  ({['South', 'North', 'East', 'West', 'Pickup', 'Dropoff'][self.lastaction]})\n"
        else:
            out += "\n"
        return out

    def _render_rgb(self) -> np.ndarray:
        from gymnasium_tpu_torch.utils.raster import Canvas

        cell = 65
        canvas = Canvas(5 * cell + 100, 5 * cell + 50, (230, 220, 200))
        taxi_row, taxi_col, pass_idx, dest_idx = decode(int(self.s))
        colors = [(255, 0, 0), (0, 255, 0), (255, 255, 0), (0, 0, 255)]
        for i, (r, c) in enumerate(self.locs):
            canvas.polygon(
                [
                    (c * cell + 5, r * cell + 5),
                    ((c + 1) * cell - 5, r * cell + 5),
                    ((c + 1) * cell - 5, (r + 1) * cell - 5),
                    (c * cell + 5, (r + 1) * cell - 5),
                ],
                colors[i],
            )
        dr, dc = self.locs[dest_idx]
        canvas.circle((dc * cell + cell / 2, dr * cell + cell / 2), cell / 6, (120, 0, 120))
        canvas.circle(
            (taxi_col * cell + cell / 2, taxi_row * cell + cell / 2),
            cell / 3,
            (255, 200, 0) if pass_idx < 4 else (0, 160, 0),
        )
        frame = canvas.rgb_array()
        if self.render_mode == "human":
            if not hasattr(self, "_display") or self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(
                    frame.shape[1], frame.shape[0], self.metadata["render_fps"], "Taxi"
                )
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if getattr(self, "_display", None) is not None:
            self._display.close()
            self._display = None
