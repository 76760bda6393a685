"""Vector-level rendering wrappers: HumanRendering and RecordVideo (copy of
the JAX package's ``wrappers/vector/rendering.py``).

Parity surface: reference gymnasium/wrappers/vector/rendering.py:22-194.
They tile the sub-envs' host frames; a vector env that renders nothing, as
``TorchVectorEnv`` and JAX's device env do, has no frames to show or record.
"""

from __future__ import annotations

import os
from copy import deepcopy
from typing import Any, Callable

import numpy as np

from gymnasium_tpu_torch import error, logger
from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorWrapper

__all__ = ["HumanRendering", "RecordVideo"]


class HumanRendering(VectorWrapper):
    """Tile sub-env frames into one window for human display."""

    ACCEPTED_RENDER_MODES = [
        "rgb_array",
        "rgb_array_list",
        "depth_array",
        "depth_array_list",
    ]

    def __init__(self, env: VectorEnv, screen_size: tuple[int, int] | None = None):
        super().__init__(env)
        self.screen_size = screen_size
        self._display = None
        self._scaled_subenv_size = None
        self._subenv_grid = None

        assert self.env.render_mode in self.ACCEPTED_RENDER_MODES, (
            f"Expected env.render_mode to be one of {self.ACCEPTED_RENDER_MODES} but got '{env.render_mode}'"
        )
        assert "render_fps" in self.env.metadata, (
            "The base environment must specify 'render_fps' to be used with the HumanRendering wrapper"
        )

        self.metadata = deepcopy(self.env.metadata)
        if "human" not in self.metadata["render_modes"]:
            self.metadata["render_modes"].append("human")

    @property
    def render_mode(self):
        """Always ``human``."""
        return "human"

    def step(self, actions):
        result = super().step(actions)
        self._render_frame()
        return result

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        result = super().reset(seed=seed, options=options)
        self._render_frame()
        return result

    def _render_frame(self):
        frames = self.env.render()
        if isinstance(frames, tuple) and len(frames) and isinstance(frames[0], list):
            frames = tuple(f[-1] for f in frames)
        assert frames is not None and len(frames) == self.num_envs
        assert all(isinstance(frame, np.ndarray) for frame in frames)

        subenv_shape = frames[0].shape
        cols = int(np.ceil(np.sqrt(self.num_envs)))
        rows = int(np.ceil(self.num_envs / cols))
        h, w = subenv_shape[0], subenv_shape[1]
        mosaic = np.zeros((rows * h, cols * w, 3), dtype=np.uint8)
        for i, frame in enumerate(frames):
            r, c = divmod(i, cols)
            mosaic[r * h : (r + 1) * h, c * w : (c + 1) * w] = frame

        if self._display is None:
            from gymnasium_tpu_torch.utils.human_display import HumanDisplay

            self._display = HumanDisplay(
                mosaic.shape[1],
                mosaic.shape[0],
                self.metadata.get("render_fps", 30),
                str(self.env),
            )
        self._display.show(mosaic)

    def render(self):
        """Human rendering returns None."""
        return None

    def close(self):
        super().close()
        if self._display is not None:
            self._display.close()
            self._display = None


class RecordVideo(VectorWrapper):
    """Record videos of the first sub-env's frames."""

    def __init__(
        self,
        env: VectorEnv,
        video_folder: str,
        episode_trigger: Callable[[int], bool] | None = None,
        step_trigger: Callable[[int], bool] | None = None,
        video_length: int = 0,
        name_prefix: str = "rl-video",
        fps: int | None = None,
        disable_logger: bool = True,
        record_first_only: bool = False,
        video_aspect_ratio: tuple[int, int] = (1, 1),
        gc_trigger: Callable[[int], bool] | None = None,
    ):
        super().__init__(env)

        if env.render_mode in {None, "human", "ansi"}:
            raise ValueError(
                f"Render mode is {env.render_mode}, which is incompatible with RecordVideo."
            )

        if episode_trigger is None and step_trigger is None:
            from gymnasium_tpu_torch.wrappers.rendering import capped_cubic_video_schedule

            episode_trigger = capped_cubic_video_schedule
        self.episode_trigger = episode_trigger
        self.step_trigger = step_trigger
        self.disable_logger = disable_logger
        self.gc_trigger = gc_trigger

        #: record either the first sub-env or all of them tiled into a grid
        #: whose shape best matches ``video_aspect_ratio`` (reference
        #: wrappers/vector/rendering.py:336-368)
        self.record_first_only = record_first_only
        self.video_aspect_ratio = video_aspect_ratio
        self._grid_shape: tuple[int, int] | None = None

        self.video_folder = os.path.abspath(video_folder)
        os.makedirs(self.video_folder, exist_ok=True)

        if fps is None:
            fps = self.metadata.get("render_fps", 30)
        self.frames_per_sec = fps
        self.name_prefix = name_prefix
        self._video_name: str | None = None
        self.video_length = video_length if video_length != 0 else float("inf")
        self.recording = False
        self.recorded_frames: list = []

        self.step_id = -1
        self.episode_id = -1

        # encoder preference: moviepy > OpenCV VideoWriter > raw .npz dump
        # (same fallback chain as the single-env RecordVideo)
        try:
            import moviepy  # noqa: F401

            self._encoder = "moviepy"
        except ImportError:
            try:
                import cv2  # noqa: F401

                self._encoder = "cv2"
            except ImportError:
                self._encoder = "npz"
                logger.warn(
                    "Neither moviepy nor OpenCV is installed; RecordVideo will save raw frames as .npz instead of encoded video."
                )

    def _choose_grid(self, n: int, h: int, w: int) -> tuple[int, int]:
        """(rows, cols) factorization of n whose tiled aspect ratio is
        closest to the requested one."""
        target = self.video_aspect_ratio[0] / self.video_aspect_ratio[1]
        best, best_diff = (1, n), float("inf")
        for small in range(1, int(n**0.5) + 1):
            if n % small == 0:
                for rows, cols in ((small, n // small), (n // small, small)):
                    diff = abs((cols * w) / (rows * h) - target)
                    if diff < best_diff:
                        best, best_diff = (rows, cols), diff
        return best

    def _capture_frame(self):
        frames = self.env.render()
        if isinstance(frames, (tuple, list)):
            # peel the *_list render form (per-env lists of frames)
            frames = [f[-1] if isinstance(f, list) else f for f in frames]
        else:
            frames = [frames]
        if not all(isinstance(f, np.ndarray) for f in frames):
            self.stop_recording()
            logger.warn(
                f"Unable to record frame of type {type(frames[0])}; stopping recording."
            )
            return
        if self.record_first_only:
            frames = frames[:1]
        if len(frames) == 1:
            self.recorded_frames.append(frames[0])
            return
        h, w, c = frames[0].shape
        if self._grid_shape is None:
            self._grid_shape = self._choose_grid(len(frames), h, w)
        rows, cols = self._grid_shape
        grid = np.zeros((rows * h, cols * w, c), dtype=frames[0].dtype)
        for idx, f in enumerate(frames):
            r, col = divmod(idx, cols)
            grid[r * h : (r + 1) * h, col * w : (col + 1) * w] = f
        self.recorded_frames.append(grid)

    def _on_episode_boundary(self):
        """Episode accounting follows the FIRST sub-env (reference
        wrappers/vector/rendering.py:418-438)."""
        self.episode_id += 1
        if self.recording and self.video_length == float("inf"):
            self.stop_recording()
        if self.episode_trigger and self.episode_trigger(self.episode_id):
            self.start_recording(f"{self.name_prefix}-episode-{self.episode_id}")

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        if options is None or "reset_mask" not in options or options["reset_mask"][0]:
            self._on_episode_boundary()
        result = super().reset(seed=seed, options=options)
        if self.recording:
            self._capture_frame()
            if len(self.recorded_frames) > self.video_length:
                self.stop_recording()
        self._has_autoreset = False
        return result

    def step(self, actions):
        from gymnasium_tpu_torch.vector.vector_env import AutoresetMode

        obs, rewards, terms, truncs, info = self.env.step(actions)
        self.step_id += 1

        mode = self.env.metadata.get("autoreset_mode")
        if mode == AutoresetMode.NEXT_STEP:
            if getattr(self, "_has_autoreset", False):
                self._on_episode_boundary()
            self._has_autoreset = bool(terms[0] or truncs[0])
        elif mode == AutoresetMode.SAME_STEP and (terms[0] or truncs[0]):
            self._on_episode_boundary()

        if self.step_trigger and self.step_trigger(self.step_id):
            self.start_recording(f"{self.name_prefix}-step-{self.step_id}")
        if self.recording:
            self._capture_frame()
            if len(self.recorded_frames) > self.video_length:
                self.stop_recording()
        return obs, rewards, terms, truncs, info

    def start_recording(self, video_name: str):
        """Begin recording frames under ``video_name`` (an in-flight
        recording is flushed first)."""
        if self.recording:
            self.stop_recording()
        self.recording = True
        self._video_name = video_name

    def _cv2_write(self, path: str) -> bool:
        """Encode recorded frames with OpenCV; False if the codec is
        unavailable (caller then falls through to the raw .npz dump)."""
        import cv2

        h, w = self.recorded_frames[0].shape[:2]
        writer = cv2.VideoWriter(
            path, cv2.VideoWriter_fourcc(*"mp4v"), self.frames_per_sec, (w, h)
        )
        if not writer.isOpened():
            writer.release()
            logger.warn("OpenCV VideoWriter could not open the mp4v codec; saving raw frames instead.")
            return False
        for frame in self.recorded_frames:
            writer.write(np.asarray(frame)[..., ::-1].copy())  # RGB -> BGR
        writer.release()
        return True

    def stop_recording(self):
        """Flush recorded frames to disk and stop recording."""
        assert self.recording
        if len(self.recorded_frames) == 0:
            logger.warn("Ignored saving a video as there were zero frames to save.")
        elif self._encoder == "moviepy":
            from moviepy.video.io.ImageSequenceClip import ImageSequenceClip

            clip = ImageSequenceClip(self.recorded_frames, fps=self.frames_per_sec)
            clip.write_videofile(
                os.path.join(self.video_folder, f"{self._video_name}.mp4"),
                logger=None if self.disable_logger else "bar",
            )
        elif self._encoder == "cv2" and self._cv2_write(
            os.path.join(self.video_folder, f"{self._video_name}.mp4")
        ):
            pass
        else:
            np.savez_compressed(
                os.path.join(self.video_folder, f"{self._video_name}.npz"),
                frames=np.stack(self.recorded_frames),
                fps=self.frames_per_sec,
            )
        self.recorded_frames = []
        self.recording = False
        self._video_name = None

    def close(self):
        super().close()
        if self.recording:
            self.stop_recording()
