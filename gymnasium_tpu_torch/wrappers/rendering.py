"""Rendering wrappers: RenderCollection, HumanRendering, RecordVideo,
AddWhiteNoise, ObstructView (copy of the JAX package's ``wrappers/rendering.py``).

Parity with reference gymnasium/wrappers/rendering.py:34-719. Video encoding
prefers moviepy when installed, then OpenCV, and falls back to raw ``.npz``
frame dumps so the wrapper works in minimal environments. The port's envs
render host numpy frames, so nothing here reads a device.
"""

from __future__ import annotations

import os
from copy import deepcopy
from typing import Any, Callable, SupportsFloat

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import error, logger
from gymnasium_tpu_torch.core import ActType, ObsType, RenderFrame
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = ["RenderCollection", "RecordVideo", "HumanRendering", "AddWhiteNoise", "ObstructView"]


class RenderCollection(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Collect frames so ``render`` returns a list (reference rendering.py:34)."""

    def __init__(self, env: gym.Env, pop_frames: bool = True, reset_clean: bool = True):
        RecordConstructorArgs.__init__(self, pop_frames=pop_frames, reset_clean=reset_clean)
        gym.Wrapper.__init__(self, env)
        assert env.render_mode is not None
        assert not env.render_mode.endswith("_list")

        self.frame_list: list[RenderFrame] = []
        self.pop_frames = pop_frames
        self.reset_clean = reset_clean

        self.metadata = deepcopy(self.env.metadata)
        if f"{self.env.render_mode}_list" not in self.metadata["render_modes"]:
            self.metadata["render_modes"].append(f"{self.env.render_mode}_list")

    @property
    def render_mode(self):
        """The wrapped render mode with a ``_list`` suffix."""
        return f"{self.env.render_mode}_list"

    def step(self, action):
        output = super().step(action)
        self.frame_list.append(super().render())
        return output

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        output = super().reset(seed=seed, options=options)
        if self.reset_clean:
            self.frame_list = []
        self.frame_list.append(super().render())
        return output

    def render(self):
        frames = self.frame_list
        if self.pop_frames:
            self.frame_list = []
        return frames


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """Record on cubes up to 1000 then every 1000 (reference save_video.py:19)."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


class RecordVideo(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Record env episodes as videos (reference rendering.py:162).

    Uses moviepy when available; otherwise falls back to saving raw frames as
    a compressed ``.npz``.
    """

    def __init__(
        self,
        env: gym.Env,
        video_folder: str,
        episode_trigger: Callable[[int], bool] | None = None,
        step_trigger: Callable[[int], bool] | None = None,
        video_length: int = 0,
        name_prefix: str = "rl-video",
        fps: int | None = None,
        disable_logger: bool = True,
    ):
        RecordConstructorArgs.__init__(
            self,
            video_folder=video_folder,
            episode_trigger=episode_trigger,
            step_trigger=step_trigger,
            video_length=video_length,
            name_prefix=name_prefix,
            fps=fps,
            disable_logger=disable_logger,
        )
        gym.Wrapper.__init__(self, env)

        if env.render_mode in {None, "human", "ansi", "ansi_list"}:
            raise ValueError(
                f"Render mode is {env.render_mode}, which is incompatible with RecordVideo."
                " Initialize your environment with a render_mode that returns an image, such as rgb_array."
            )

        if episode_trigger is None and step_trigger is None:
            episode_trigger = capped_cubic_video_schedule
        self.episode_trigger = episode_trigger
        self.step_trigger = step_trigger
        self.disable_logger = disable_logger

        self.video_folder = os.path.abspath(video_folder)
        if os.path.isdir(self.video_folder):
            logger.warn(
                f"Overwriting existing videos at {self.video_folder} folder "
                "(try specifying a different `video_folder` for the `RecordVideo` wrapper if this is not desired)"
            )
        os.makedirs(self.video_folder, exist_ok=True)

        if fps is None:
            fps = self.metadata.get("render_fps", 30)
        self.frames_per_sec: int = fps
        self.name_prefix: str = name_prefix
        self._video_name: str | None = None
        self.video_length: int = video_length if video_length != 0 else float("inf")  # type: ignore[assignment]
        self.recording: bool = False
        self.recorded_frames: list[RenderFrame] = []
        self.render_history: list[RenderFrame] = []

        self.step_id = -1
        self.episode_id = -1

        # encoder preference: moviepy > OpenCV VideoWriter > raw .npz dump
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

    def _capture_frame(self):
        assert self.recording, "Cannot capture a frame, recording wasn't started."
        frame = self.env.render()
        if isinstance(frame, list):
            if len(frame) == 0:
                return
            self.render_history += frame
            frame = frame[-1]
        if isinstance(frame, np.ndarray):
            self.recorded_frames.append(frame)
        else:
            self.stop_recording()
            logger.warn(
                f"Recording stopped: expected type of frame returned by render to be a numpy array, got instead {type(frame)}."
            )

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        obs, info = super().reset(seed=seed, options=options)
        self.episode_id += 1
        if self.recording and self.video_length == float("inf"):
            self.stop_recording()
        if self.episode_trigger and self.episode_trigger(self.episode_id):
            self.start_recording(f"{self.name_prefix}-episode-{self.episode_id}")
        if self.recording:
            self._capture_frame()
            if len(self.recorded_frames) > self.video_length:
                self.stop_recording()
        return obs, info

    def step(self, action):
        obs, rew, terminated, truncated, info = self.env.step(action)
        self.step_id += 1
        if self.step_trigger and self.step_trigger(self.step_id):
            self.start_recording(f"{self.name_prefix}-step-{self.step_id}")
        if self.recording:
            self._capture_frame()
            if len(self.recorded_frames) > self.video_length:
                self.stop_recording()
        return obs, rew, terminated, truncated, info

    def render(self):
        render_out = super().render()
        if self.recording and isinstance(render_out, list):
            self.recorded_frames += render_out
        if len(self.render_history) > 0:
            tmp_history = self.render_history
            self.render_history = []
            return tmp_history + render_out
        return render_out

    def close(self):
        super().close()
        if self.recording:
            self.stop_recording()

    def start_recording(self, video_name: str):
        """Begin recording under ``video_name``; an in-progress recording is
        saved first (reference rendering.py:394-400)."""
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
        assert self.recording, "stop_recording was called, but no recording was started"
        if len(self.recorded_frames) == 0:
            logger.warn("Ignored saving a video as there were zero frames to save.")
        elif self._encoder == "moviepy":
            from moviepy.video.io.ImageSequenceClip import ImageSequenceClip

            clip = ImageSequenceClip(self.recorded_frames, fps=self.frames_per_sec)
            moviepy_logger = None if self.disable_logger else "bar"
            path = os.path.join(self.video_folder, f"{self._video_name}.mp4")
            clip.write_videofile(path, logger=moviepy_logger)
        elif self._encoder == "cv2" and self._cv2_write(
            os.path.join(self.video_folder, f"{self._video_name}.mp4")
        ):
            pass
        else:
            path = os.path.join(self.video_folder, f"{self._video_name}.npz")
            np.savez_compressed(
                path, frames=np.stack(self.recorded_frames), fps=self.frames_per_sec
            )
        self.recorded_frames = []
        self.recording = False
        self._video_name = None


class HumanRendering(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Display an rgb_array env in a window (reference rendering.py:436)."""

    ACCEPTED_RENDER_MODES = [
        "rgb_array",
        "rgb_array_list",
        "depth_array",
        "depth_array_list",
    ]

    def __init__(self, env: gym.Env):
        RecordConstructorArgs.__init__(self)
        gym.Wrapper.__init__(self, env)

        self.screen_size: tuple[int, int] | None = None
        self._display = None

        assert self.env.render_mode in self.ACCEPTED_RENDER_MODES, (
            f"Expected env.render_mode to be one of {self.ACCEPTED_RENDER_MODES} but got '{env.render_mode}'"
        )
        assert "render_fps" in self.env.metadata, "The base environment must specify 'render_fps' to be used with the HumanRendering wrapper"

        self.metadata = deepcopy(self.env.metadata)
        if "human" not in self.metadata["render_modes"]:
            self.metadata["render_modes"].append("human")

    @property
    def render_mode(self):
        """Always ``human``."""
        return "human"

    def step(self, action):
        result = super().step(action)
        self._render_frame()
        return result

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        result = super().reset(seed=seed, options=options)
        self._render_frame()
        return result

    def render(self) -> None:
        """Human rendering returns None."""
        return None

    def _render_frame(self):
        if self.env.render_mode == "rgb_array_list":
            last_rgb_array = self.env.render()
            assert isinstance(last_rgb_array, list)
            last_rgb_array = last_rgb_array[-1]
        else:
            last_rgb_array = self.env.render()
        assert isinstance(last_rgb_array, np.ndarray), (
            f"Expected `env.render()` to return a numpy array, actually returned {type(last_rgb_array)}"
        )

        rgb_array = np.transpose(last_rgb_array, axes=(1, 0, 2))
        if self.screen_size is None:
            self.screen_size = rgb_array.shape[:2]
        assert self.screen_size == rgb_array.shape[:2], (
            f"The shape of the rgb array has changed from {self.screen_size} to {rgb_array.shape[:2]}"
        )

        if self._display is None:
            from gymnasium_tpu_torch.utils.human_display import HumanDisplay

            self._display = HumanDisplay(
                self.screen_size[0],
                self.screen_size[1],
                self.metadata["render_fps"],
                str(self.env),
            )
        self._display.show(last_rgb_array)

    def close(self):
        super().close()
        if self._display is not None:
            self._display.close()
            self._display = None


class AddWhiteNoise(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Randomly replace rendered pixels with white (or grayscale) noise
    (reference rendering.py:584-658)."""

    def __init__(
        self,
        env: gym.Env,
        probability_of_noise_per_pixel: float,
        is_noise_grayscale: bool = False,
    ):
        if not 0 <= probability_of_noise_per_pixel < 1:
            raise error.InvalidProbability(
                f"probability_of_noise_per_pixel should be in the interval [0,1). Received {probability_of_noise_per_pixel}"
            )
        RecordConstructorArgs.__init__(
            self,
            probability_of_noise_per_pixel=probability_of_noise_per_pixel,
            is_noise_grayscale=is_noise_grayscale,
        )
        gym.Wrapper.__init__(self, env)
        self.probability_of_noise_per_pixel = probability_of_noise_per_pixel
        self.is_noise_grayscale = is_noise_grayscale

    def _make_noise(self, shape):
        if self.is_noise_grayscale:
            return (
                self.np_random.integers(
                    (0, 0, 0),
                    255 * np.array([0.2989, 0.5870, 0.1140]),
                    size=shape,
                    dtype=np.uint8,
                )
                .sum(-1, keepdims=True)
                .repeat(3, -1)
            )
        return self.np_random.integers(0, 255, size=shape, dtype=np.uint8)

    def render(self):
        render_out = super().render()
        if isinstance(render_out, np.ndarray):
            mask = (
                self.np_random.random(render_out.shape[:2]) < self.probability_of_noise_per_pixel
            )
            return np.where(mask[..., None], self._make_noise(render_out.shape), render_out)
        return render_out


class ObstructView(gym.Wrapper[ObsType, ActType, ObsType, ActType], RecordConstructorArgs):
    """Obstruct square patches of the rendered view with noise
    (reference rendering.py:660-760)."""

    def __init__(
        self,
        env: gym.Env,
        obstructed_pixels_ratio: float,
        obstruction_width: int,
        is_noise_grayscale: bool = False,
    ):
        if not 0 <= obstructed_pixels_ratio < 1:
            raise ValueError(
                f"obstructed_pixels_ratio should be in the interval [0,1). Received {obstructed_pixels_ratio}"
            )
        if obstruction_width < 1:
            raise ValueError(
                f"obstruction_width should be larger or equal than 1. Received {obstruction_width}"
            )
        RecordConstructorArgs.__init__(
            self,
            obstructed_pixels_ratio=obstructed_pixels_ratio,
            obstruction_width=obstruction_width,
            is_noise_grayscale=is_noise_grayscale,
        )
        gym.Wrapper.__init__(self, env)
        self.obstruction_centers_ratio = obstructed_pixels_ratio / obstruction_width**2
        self.obstruction_width = obstruction_width
        self.is_noise_grayscale = is_noise_grayscale

    def render(self):
        render_out = super().render()
        if not isinstance(render_out, np.ndarray):
            return render_out
        h, w = render_out.shape[:2]
        n_pixels = h * w
        n_obstructions = int(n_pixels * self.obstruction_centers_ratio)
        centers = self.np_random.integers(0, n_pixels, n_obstructions)
        centers = np.unravel_index(centers, (h, w))
        mask = np.zeros((h, w), dtype=bool)
        low = self.obstruction_width // 2
        high = self.obstruction_width - low
        for x, y in zip(*centers):
            mask[max(x - low, 0) : min(x + high, h), max(y - low, 0) : min(y + high, w)] = True

        if self.is_noise_grayscale:
            noise = (
                self.np_random.integers(
                    (0, 0, 0),
                    255 * np.array([0.2989, 0.5870, 0.1140]),
                    size=render_out.shape,
                    dtype=np.uint8,
                )
                .sum(-1, keepdims=True)
                .repeat(3, -1)
            )
        else:
            noise = self.np_random.integers(0, 255, size=render_out.shape, dtype=np.uint8)
        return np.where(mask[..., None], noise, render_out)
