"""CliffWalking: the host env class over the dense model (own copy of the
JAX package's ``envs/toy_text/cliffwalking.py``).

Reference toy_text/cliffwalking.py:103-213: a 4x12 grid whose cliff row
sends the walker back to the start with -100 and no termination, with
optional slippery perpendicular moves. The env runs on the host in numpy
and takes no device.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularHostEnv, TabularModel, model_from_P

__all__ = ["CliffWalkingEnv", "build_cliffwalking_model"]

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


class CliffWalkingEnv(TabularHostEnv):
    """Walk along the cliff edge from bottom-left to bottom-right."""

    metadata = {"render_modes": ["human", "ansi", "rgb_array"], "render_fps": 4}

    def __init__(self, render_mode: str | None = None, is_slippery: bool = False):
        self.shape = (4, 12)
        self.start_state_index = 3 * 12
        self.is_slippery = is_slippery
        self._cliff = np.zeros(self.shape, dtype=bool)
        self._cliff[3, 1:-1] = True
        super().__init__(build_cliffwalking_model(is_slippery), render_mode)

    def render(self):
        if self.render_mode is None:
            import gymnasium_tpu_torch.logger as logger

            logger.warn("You are calling render method without specifying any render mode.")
            return None
        if self.render_mode == "ansi":
            return self._render_text()
        return self._render_rgb()

    def _render_text(self) -> str:
        outfile = []
        for s in range(self.model.num_states):
            row, col = s // self.shape[1], s % self.shape[1]
            if self.s == s:
                output = " x "
            elif (row, col) == (self.shape[0] - 1, self.shape[1] - 1):
                output = " T "
            elif self._cliff[row, col]:
                output = " C "
            else:
                output = " o "
            if col == 0:
                output = output.lstrip()
            if col == self.shape[1] - 1:
                output = output.rstrip() + "\n"
            outfile.append(output)
        return "".join(outfile)

    def _render_rgb(self) -> np.ndarray:
        from gymnasium_tpu_torch.utils.raster import Canvas

        cell = 60
        canvas = Canvas(self.shape[1] * cell, self.shape[0] * cell, (150, 180, 150))
        for r in range(self.shape[0]):
            for c in range(self.shape[1]):
                if self._cliff[r, c]:
                    color = (60, 40, 40)
                elif (r, c) == (self.shape[0] - 1, self.shape[1] - 1):
                    color = (250, 220, 100)
                else:
                    color = (150, 180, 150)
                canvas.polygon(
                    [
                        (c * cell + 1, r * cell + 1),
                        ((c + 1) * cell - 1, r * cell + 1),
                        ((c + 1) * cell - 1, (r + 1) * cell - 1),
                        (c * cell + 1, (r + 1) * cell - 1),
                    ],
                    color,
                )
        row, col = self.s // self.shape[1], self.s % self.shape[1]
        canvas.circle((col * cell + cell / 2, row * cell + cell / 2), cell / 3, (200, 60, 60))
        frame = canvas.rgb_array()
        if self.render_mode == "human":
            if not hasattr(self, "_display") or self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(
                    frame.shape[1], frame.shape[0], self.metadata["render_fps"], "CliffWalking"
                )
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if getattr(self, "_display", None) is not None:
            self._display.close()
            self._display = None
