"""Save episode frame lists as videos (copy of the JAX package's
``utils/save_video.py``).

Parity surface: reference gymnasium/utils/save_video.py:19-110. moviepy is
optional; without it OpenCV writes the video, and without both the frames
are saved as compressed ``.npz``.
"""

from __future__ import annotations

import os
from typing import Any, Callable

import numpy as np

import gymnasium_tpu_torch.logger as logger

__all__ = ["save_video", "capped_cubic_video_schedule"]


def capped_cubic_video_schedule(episode_id: int) -> bool:
    """Record on cube numbers below 1000, then every 1000 episodes."""
    if episode_id < 1000:
        return int(round(episode_id ** (1.0 / 3))) ** 3 == episode_id
    return episode_id % 1000 == 0


def save_video(
    frames: list,
    video_folder: str,
    episode_trigger: Callable[[int], bool] | None = None,
    step_trigger: Callable[[int], bool] | None = None,
    video_length: int | None = None,
    name_prefix: str = "rl-video",
    episode_index: int = 0,
    step_starting_index: int = 0,
    fps: int = 30,
    save_logger: str | None = None,
    **kwargs: Any,
):
    """Save a list of rendered frames as one or more video files."""
    if not isinstance(frames, list):
        logger.error(f"Expected a list of frames, got a {type(frames)} instead.")
    if episode_trigger is None and step_trigger is None:
        episode_trigger = capped_cubic_video_schedule

    video_folder = os.path.abspath(video_folder)
    os.makedirs(video_folder, exist_ok=True)
    path_prefix = f"{video_folder}/{name_prefix}"

    def _write(clip_frames, path):
        # encoder chain matches RecordVideo: moviepy > OpenCV > raw .npz
        try:
            from moviepy.video.io.ImageSequenceClip import ImageSequenceClip

            clip = ImageSequenceClip(clip_frames, fps=fps)
            clip.write_videofile(f"{path}.mp4", logger=save_logger, **kwargs)
            return
        except ImportError:
            pass
        try:
            import cv2

            h, w = clip_frames[0].shape[:2]
            writer = cv2.VideoWriter(
                f"{path}.mp4", cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
            )
            if writer.isOpened():
                for frame in clip_frames:
                    writer.write(np.asarray(frame)[..., ::-1].copy())  # RGB -> BGR
                writer.release()
                return
            writer.release()
            logger.warn("OpenCV VideoWriter could not open the mp4v codec.")
        except ImportError:
            pass
        np.savez_compressed(f"{path}.npz", frames=np.stack(clip_frames), fps=fps)
        logger.warn(
            "No working video encoder (moviepy or OpenCV with mp4v) is available; frames were saved as .npz instead of encoded video."
        )

    if episode_trigger is not None and episode_trigger(episode_index):
        clip_frames = frames[: video_length if video_length is not None else len(frames)]
        _write(clip_frames, f"{path_prefix}-episode-{episode_index}")

    if step_trigger is not None:
        for step_index in range(len(frames)):
            if step_trigger(step_starting_index + step_index):
                end = (
                    step_index + video_length if video_length is not None else len(frames)
                )
                _write(
                    frames[step_index:end],
                    f"{path_prefix}-step-{step_starting_index + step_index}",
                )
