"""CliffWalking's dense model (own copy of ``build_cliffwalking_model`` in the JAX package's
``envs/toy_text/cliffwalking.py``).

Reference toy_text/cliffwalking.py:103-213: a 4x12 grid whose cliff row
sends the walker back to the start with -100 and no termination, with
optional slippery perpendicular moves. The host env is not ported.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel, model_from_P

__all__ = ["build_cliffwalking_model"]

UP, RIGHT, DOWN, LEFT = 0, 1, 2, 3
_DELTAS = {UP: (-1, 0), RIGHT: (0, 1), DOWN: (1, 0), LEFT: (0, -1)}


def build_cliffwalking_model(is_slippery: bool = False) -> TabularModel:
    """Dense transition tensors for the 4x12 cliff gridworld."""
    shape = (4, 12)
    n_states = shape[0] * shape[1]
    start = 3 * shape[1] + 0
    goal = (shape[0] - 1, shape[1] - 1)

    cliff = np.zeros(shape, dtype=bool)
    cliff[3, 1:-1] = True

    def outcomes(row, col, a):
        moves = [a] if not is_slippery else [(a - 1) % 4, a, (a + 1) % 4]
        result = []
        for m in moves:
            dr, dc = _DELTAS[m]
            nr = min(max(row + dr, 0), shape[0] - 1)
            nc = min(max(col + dc, 0), shape[1] - 1)
            if cliff[nr, nc]:
                result.append((1 / len(moves), start, -100, False))
            else:
                result.append((1 / len(moves), nr * shape[1] + nc, -1, (nr, nc) == goal))
        return result

    P: dict = {s: {a: outcomes(s // shape[1], s % shape[1], a) for a in range(4)} for s in range(n_states)}
    initial = np.zeros(n_states)
    initial[start] = 1.0
    return model_from_P(P, initial)
