"""MujocoRenderer compatibility layer over the software 3D rasterizer.

Mirrors the reference's renderer-manager surface
(reference gymnasium/envs/mujoco/mujoco_rendering.py:685-800): every robot
env exposes ``env.mujoco_renderer`` with ``render(render_mode)`` /
``close()`` / ``_get_viewer(render_mode)``, and the per-mode viewer supports
``add_overlay(gridpos, text1, text2)`` (reference WindowViewer/
OffScreenViewer, mujoco_rendering.py:85) plus a mutable ``cam`` whose
``azimuth/elevation/distance/lookat`` steer the tracking camera (reference
viewers expose MuJoCo's ``MjvCamera``). Overlay text is rasterized with
pygame's font module directly into the frame, so it works for both the
human window and offscreen ``rgb_array`` captures.
"""

from __future__ import annotations

from typing import Any

import numpy as np

__all__ = [
    "MujocoRenderer",
    "GRID_TOPLEFT",
    "GRID_TOPRIGHT",
    "GRID_BOTTOMLEFT",
    "GRID_BOTTOMRIGHT",
]

# mujoco.mjtGridPos values (mjGRID_TOPLEFT..mjGRID_BOTTOMRIGHT)
GRID_TOPLEFT = 0
GRID_TOPRIGHT = 1
GRID_BOTTOMLEFT = 2
GRID_BOTTOMRIGHT = 3


class _Camera:
    """Mutable camera state; writes flow into the env's camera config (the
    dict the rasterizer reads), mirroring live ``viewer.cam`` edits."""

    _FIELDS = ("azimuth", "elevation", "distance", "lookat")

    def __init__(self, config: dict):
        object.__setattr__(self, "_config", config)

    def __getattr__(self, name: str):
        if name in self._FIELDS:
            return self._config.get(name)
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        if name in self._FIELDS:
            self._config[name] = value
        else:
            object.__setattr__(self, name, value)


class _Viewer:
    """Per-render-mode viewer: overlay queue + camera handle."""

    def __init__(self, renderer: "MujocoRenderer", render_mode: str | None):
        self._renderer = renderer
        self.render_mode = render_mode
        self.cam = _Camera(renderer._env._camera_config)
        self._overlays: dict[int, list[tuple[str, str]]] = {}

    def add_overlay(self, gridpos: int, text1: str, text2: str) -> None:
        """Queue a two-column text overlay for the next rendered frame
        (reference mujoco_rendering.py:85-97); cleared after each frame."""
        self._overlays.setdefault(int(gridpos), []).append((str(text1), str(text2)))

    def _take_overlays(self) -> dict[int, list[tuple[str, str]]]:
        out, self._overlays = self._overlays, {}
        return out

    def close(self) -> None:
        self._overlays.clear()


def _blit_overlays(frame: np.ndarray, overlays: dict[int, list[tuple[str, str]]]) -> np.ndarray:
    """Rasterize queued overlay text onto an (H, W, 3) frame via pygame's
    font module (works headless; silently skipped if pygame is absent)."""
    if not overlays:
        return frame
    try:
        import pygame
        import pygame.font
    except ImportError:
        return frame
    if not pygame.font.get_init():
        pygame.font.init()
    font = pygame.font.SysFont(None, 16)
    H, W = frame.shape[:2]
    frame = np.ascontiguousarray(frame)
    for gridpos, lines in overlays.items():
        rendered = [font.render(f"{t1}  {t2}".strip(), True, (255, 255, 255)) for t1, t2 in lines]
        arrays = [
            np.transpose(pygame.surfarray.array3d(s), (1, 0, 2)) for s in rendered
        ]
        y = 4 if gridpos in (GRID_TOPLEFT, GRID_TOPRIGHT) else H - 4 - sum(
            a.shape[0] + 2 for a in arrays
        )
        for a in arrays:
            h, w = a.shape[:2]
            x = 4 if gridpos in (GRID_TOPLEFT, GRID_BOTTOMLEFT) else W - 4 - w
            y0, x0 = max(y, 0), max(x, 0)
            h_fit, w_fit = min(h, H - y0), min(w, W - x0)
            if h_fit > 0 and w_fit > 0:
                region = frame[y0 : y0 + h_fit, x0 : x0 + w_fit]
                text = a[:h_fit, :w_fit]
                mask = text.any(axis=-1, keepdims=True)
                frame[y0 : y0 + h_fit, x0 : x0 + w_fit] = np.where(mask, text, region)
            y += h + 2
    return frame


class MujocoRenderer:
    """Renderer manager for a :class:`MujocoEnv` (reference
    mujoco_rendering.py:685): owns one lazily-created viewer per render
    mode and routes frames through it."""

    def __init__(self, env: Any):
        self._env = env
        self._viewers: dict[str | None, _Viewer] = {}
        self.viewer: _Viewer | None = None

    def _get_viewer(self, render_mode: str | None) -> _Viewer:
        viewer = self._viewers.get(render_mode)
        if viewer is None:
            viewer = _Viewer(self, render_mode)
            self._viewers[render_mode] = viewer
        self.viewer = viewer
        return viewer

    def render(self, render_mode: str | None):
        """Render a frame in ``render_mode`` ("human" displays and returns
        None; "rgb_array"/"depth_array"/"rgbd_tuple" return arrays)."""
        env = self._env
        if render_mode is None:
            return None
        viewer = self._get_viewer(render_mode)
        if render_mode == "depth_array":
            viewer._take_overlays()
            return env._render_frame(depth=True)
        if render_mode == "rgbd_tuple":
            viewer._take_overlays()
            return env._render_frame(), env._render_frame(depth=True)
        frame = _blit_overlays(env._render_frame(), viewer._take_overlays())
        if render_mode == "human":
            if env._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                env._display = HumanDisplay(
                    env.width,
                    env.height,
                    env.metadata["render_fps"],
                    type(env).__name__,
                )
            env._display.show(frame)
            return None
        return frame

    @property
    def default_cam_config(self) -> dict:
        return self._env._camera_config

    @property
    def camera_id(self) -> int:
        """Resolved camera id: -1 = the free tracking camera; >= 0 indexes
        the model's fixed cameras (reference mujoco_rendering.py camera
        resolution semantics)."""
        env = self._env
        if env.camera_name is not None:
            for i, cam in enumerate(env.meta.get("cameras") or []):
                if cam["name"] == env.camera_name:
                    return i
            return -1
        return -1 if env.camera_id is None else int(env.camera_id)

    def close(self) -> None:
        for viewer in self._viewers.values():
            viewer.close()
        self._viewers.clear()
        self.viewer = None
        if self._env._display is not None:
            self._env._display.close()
            self._env._display = None
