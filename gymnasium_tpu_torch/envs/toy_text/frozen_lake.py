"""FrozenLake's dense model (own copy of ``build_frozen_lake_model`` in the JAX package's
``envs/toy_text/frozen_lake.py``).

Reference toy_text/frozen_lake.py:232-333: slippery moves go the intended
way with ``success_rate`` and to either side with the rest split evenly,
and ``reward_schedule`` gives the reward of reaching G, H and F. Random map
generation and the host env are not ported.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel, model_from_P

__all__ = ["MAPS", "build_frozen_lake_model"]

LEFT, DOWN, RIGHT, UP = 0, 1, 2, 3

MAPS = {
    "4x4": ["SFFF", "FHFH", "FFFH", "HFFG"],
    "8x8": [
        "SFFFFFFF",
        "FFFFFFFF",
        "FFFHFFFF",
        "FFFFFHFF",
        "FFFHFFFF",
        "FHHFFFHF",
        "FHFFHFHF",
        "FFFHFFFG",
    ],
}


def build_frozen_lake_model(
    desc: np.ndarray,
    is_slippery: bool = True,
    success_rate: float = 1.0 / 3.0,
    reward_schedule: tuple[int, int, int] = (1, 0, 0),
) -> TabularModel:
    """Dense transition tensors for a FrozenLake board (``desc`` a bytes array)."""
    nrow, ncol = desc.shape
    n_states = nrow * ncol
    fail_rate = (1.0 - success_rate) / 2.0

    def move(row, col, a):
        if a == LEFT:
            col = max(col - 1, 0)
        elif a == DOWN:
            row = min(row + 1, nrow - 1)
        elif a == RIGHT:
            col = min(col + 1, ncol - 1)
        elif a == UP:
            row = max(row - 1, 0)
        return row, col

    def outcome(row, col, b):
        nr, nc = move(row, col, b)
        letter = desc[nr, nc]
        term = letter in b"GH"
        reward = reward_schedule[b"GHF".index(letter if letter in b"GHF" else b"F")]
        return nr * ncol + nc, reward, term

    P: dict = {s: {a: [] for a in range(4)} for s in range(n_states)}
    for row in range(nrow):
        for col in range(ncol):
            s = row * ncol + col
            for a in range(4):
                if desc[row, col] in b"GH":
                    P[s][a].append((1.0, s, 0, True))
                elif is_slippery:
                    for b in [(a - 1) % 4, a, (a + 1) % 4]:
                        prob = success_rate if b == a else fail_rate
                        P[s][a].append((prob, *outcome(row, col, b)))
                else:
                    P[s][a].append((1.0, *outcome(row, col, a)))

    initial = (desc == b"S").astype(np.float64).ravel()
    initial /= initial.sum()
    return model_from_P(P, initial)
