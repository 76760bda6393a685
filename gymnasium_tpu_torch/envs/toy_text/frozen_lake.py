"""FrozenLake: the host env class over the dense model (own copy of the JAX
package's ``envs/toy_text/frozen_lake.py``).

Reference toy_text/frozen_lake.py:232-333: slippery moves go the intended
way with ``success_rate`` and to either side with the rest split evenly,
``reward_schedule`` gives the reward of reaching G, H and F, and
``generate_random_map`` draws a solvable board. The env runs on the host in
numpy and takes no device.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularHostEnv, TabularModel, model_from_P
from gymnasium_tpu_torch.utils import seeding

__all__ = ["MAPS", "FrozenLakeEnv", "build_frozen_lake_model", "generate_random_map"]

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


def _has_path(board: np.ndarray, size: int) -> bool:
    """DFS reachability of G from S avoiding holes."""
    seen = set()
    stack = [(0, 0)]
    while stack:
        r, c = stack.pop()
        if (r, c) in seen:
            continue
        seen.add((r, c))
        for dr, dc in ((1, 0), (0, 1), (-1, 0), (0, -1)):
            nr, nc = r + dr, c + dc
            if not (0 <= nr < size and 0 <= nc < size):
                continue
            if board[nr][nc] == "G":
                return True
            if board[nr][nc] != "H":
                stack.append((nr, nc))
    return False


def generate_random_map(size: int = 8, p: float = 0.8, seed: int | None = None) -> list[str]:
    """Random valid (solvable) map with frozen-tile probability ``p``."""
    np_random, _ = seeding.np_random(seed)
    while True:
        p = min(1, p)
        board = np_random.choice(["F", "H"], (size, size), p=[p, 1 - p])
        board[0][0] = "S"
        board[-1][-1] = "G"
        if _has_path(board, size):
            return ["".join(row) for row in board]


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


class FrozenLakeEnv(TabularHostEnv):
    """Cross the frozen lake from S to G without falling in a hole."""

    metadata = {"render_modes": ["human", "ansi", "rgb_array"], "render_fps": 4}

    def __init__(
        self,
        render_mode: str | None = None,
        desc: list[str] | None = None,
        map_name: str | None = "4x4",
        is_slippery: bool = True,
        success_rate: float = 1.0 / 3.0,
        reward_schedule: tuple[int, int, int] = (1, 0, 0),
    ):
        if desc is None and map_name is None:
            desc = generate_random_map()
        elif desc is None:
            desc = MAPS[map_name]
        self.desc = desc = np.asarray(desc, dtype="c")
        self.nrow, self.ncol = desc.shape
        self.reward_range = (min(reward_schedule), max(reward_schedule))
        self.is_slippery = is_slippery

        model = build_frozen_lake_model(desc, is_slippery, success_rate, reward_schedule)
        super().__init__(model, render_mode)

    def render(self):
        if self.render_mode is None:
            import gymnasium_tpu_torch.logger as logger

            logger.warn("You are calling render method without specifying any render mode.")
            return None
        if self.render_mode == "ansi":
            return self._render_text()
        return self._render_rgb()

    def _render_text(self) -> str:
        desc = self.desc.tolist()
        desc = [[c.decode("utf-8") for c in line] for line in desc]
        row, col = self.s // self.ncol, self.s % self.ncol
        from gymnasium_tpu_torch.utils.colorize import colorize

        desc[row][col] = colorize(desc[row][col], "red", highlight=True)
        out = "\n".join("".join(line) for line in desc) + "\n"
        if self.lastaction is not None:
            out = f"  ({['Left', 'Down', 'Right', 'Up'][self.lastaction]})\n" + out
        else:
            out = "\n" + out
        return out

    def _render_rgb(self) -> np.ndarray:
        from gymnasium_tpu_torch.utils.raster import Canvas

        cell = 64
        canvas = Canvas(self.ncol * cell, self.nrow * cell, (180, 200, 250))
        colors = {b"S": (120, 180, 120), b"F": (180, 200, 250), b"H": (40, 40, 80), b"G": (250, 220, 100)}
        for r in range(self.nrow):
            for c in range(self.ncol):
                color = colors[self.desc[r, c]]
                canvas.polygon(
                    [
                        (c * cell + 1, r * cell + 1),
                        ((c + 1) * cell - 1, r * cell + 1),
                        ((c + 1) * cell - 1, (r + 1) * cell - 1),
                        (c * cell + 1, (r + 1) * cell - 1),
                    ],
                    color,
                )
        row, col = self.s // self.ncol, self.s % self.ncol
        canvas.circle((col * cell + cell / 2, row * cell + cell / 2), cell / 3, (200, 60, 60))
        frame = canvas.rgb_array()
        if self.render_mode == "human":
            self._show_human(frame)
            return None
        return frame

    def _show_human(self, frame):
        if not hasattr(self, "_display") or self._display is None:
            from gymnasium_tpu_torch.utils.human_display import HumanDisplay

            self._display = HumanDisplay(
                frame.shape[1], frame.shape[0], self.metadata["render_fps"], "FrozenLake"
            )
        self._display.show(frame)

    def close(self):
        if getattr(self, "_display", None) is not None:
            self._display.close()
            self._display = None
