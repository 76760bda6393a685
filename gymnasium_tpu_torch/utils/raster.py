"""Tiny numpy rasterizer for host-side ``rgb_array`` rendering.

The reference renders through pygame/SDL (C). Here rendering is decoupled
from the simulation entirely: environments render from plain state arrays
into numpy RGB buffers with no native dependency, keeping the device hot path
untouched. ``human`` render modes display these buffers via pygame when it is
installed (see gymnasium_tpu_torch/utils/human_display.py).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Canvas"]


class Canvas:
    """A ``(height, width, 3)`` uint8 RGB draw target with simple primitives."""

    def __init__(self, width: int, height: int, background=(255, 255, 255)):
        self.width = int(width)
        self.height = int(height)
        self.buffer = np.empty((self.height, self.width, 3), dtype=np.uint8)
        self.fill(background)

    def fill(self, color) -> None:
        self.buffer[:] = np.asarray(color, dtype=np.uint8)

    def _paint(self, mask: np.ndarray, color) -> None:
        self.buffer[mask] = np.asarray(color, dtype=np.uint8)

    def polygon(self, points, color) -> None:
        """Fill a polygon given ``[(x, y), ...]`` vertices (y measured down)."""
        pts = np.asarray(points, dtype=np.float64)
        if len(pts) < 3:
            return
        x0 = max(int(np.floor(pts[:, 0].min())), 0)
        x1 = min(int(np.ceil(pts[:, 0].max())) + 1, self.width)
        y0 = max(int(np.floor(pts[:, 1].min())), 0)
        y1 = min(int(np.ceil(pts[:, 1].max())) + 1, self.height)
        if x0 >= x1 or y0 >= y1:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        xs = xs + 0.5
        ys = ys + 0.5
        inside = np.zeros(xs.shape, dtype=bool)
        n = len(pts)
        # even-odd crossing test, vectorized over the bounding box
        for i in range(n):
            xa, ya = pts[i]
            xb, yb = pts[(i + 1) % n]
            cond = (ya > ys) != (yb > ys)
            with np.errstate(divide="ignore", invalid="ignore"):
                x_int = xa + (ys - ya) * (xb - xa) / (yb - ya)
            inside ^= cond & (xs < x_int)
        self.buffer[y0:y1, x0:x1][inside] = np.asarray(color, dtype=np.uint8)

    def circle(self, center, radius: float, color) -> None:
        cx, cy = float(center[0]), float(center[1])
        x0 = max(int(np.floor(cx - radius)), 0)
        x1 = min(int(np.ceil(cx + radius)) + 1, self.width)
        y0 = max(int(np.floor(cy - radius)), 0)
        y1 = min(int(np.ceil(cy + radius)) + 1, self.height)
        if x0 >= x1 or y0 >= y1:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        mask = (xs + 0.5 - cx) ** 2 + (ys + 0.5 - cy) ** 2 <= radius**2
        self.buffer[y0:y1, x0:x1][mask] = np.asarray(color, dtype=np.uint8)

    def line(self, start, end, color, width: float = 1.0) -> None:
        """Draw a thick segment as a distance-field stroke."""
        ax, ay = float(start[0]), float(start[1])
        bx, by = float(end[0]), float(end[1])
        pad = width / 2 + 1
        x0 = max(int(min(ax, bx) - pad), 0)
        x1 = min(int(max(ax, bx) + pad) + 1, self.width)
        y0 = max(int(min(ay, by) - pad), 0)
        y1 = min(int(max(ay, by) + pad) + 1, self.height)
        if x0 >= x1 or y0 >= y1:
            return
        ys, xs = np.mgrid[y0:y1, x0:x1]
        px = xs + 0.5 - ax
        py = ys + 0.5 - ay
        dx, dy = bx - ax, by - ay
        seg_len2 = dx * dx + dy * dy
        if seg_len2 == 0:
            t = np.zeros_like(px)
        else:
            t = np.clip((px * dx + py * dy) / seg_len2, 0.0, 1.0)
        dist2 = (px - t * dx) ** 2 + (py - t * dy) ** 2
        mask = dist2 <= (width / 2) ** 2
        self.buffer[y0:y1, x0:x1][mask] = np.asarray(color, dtype=np.uint8)

    def hline(self, y: float, color, width: float = 1.0) -> None:
        self.line((0, y), (self.width, y), color, width)

    def rgb_array(self) -> np.ndarray:
        """The current frame (copy)."""
        return self.buffer.copy()
