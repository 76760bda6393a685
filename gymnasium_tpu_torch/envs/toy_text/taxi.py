"""Taxi's dense model (own copy of ``build_taxi_model`` in the JAX package's
``envs/toy_text/taxi.py``).

Reference toy_text/taxi.py:278-440: the 500-state Dietterich taxi MDP with
``is_rainy`` perpendicular slips. The host env and ``fickle_passenger``'s
post-step rewrite are not ported.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel, model_from_P

__all__ = ["LOCS", "MAP", "build_taxi_model", "decode", "encode"]

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
