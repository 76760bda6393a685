"""AtariPreprocessing: the standard Machado et al. (2018) pipeline (copy of
the JAX package's ``wrappers/atari_preprocessing.py``).

Parity surface: reference gymnasium/wrappers/atari_preprocessing.py:16 —
NoopReset, frame-skip with max-pooling, grayscale + 84x84 resize, optional
life-loss termination and reward scaling. Works against any pixel env that
exposes the ALE-style hooks (no ALE envs ship in-tree; the wrapper stays
usable against custom pixel envs, SURVEY.md §2.10).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = ["AtariPreprocessing"]


class AtariPreprocessing(gym.Wrapper, RecordConstructorArgs):
    """Atari 2600 preprocessing: noop starts, frame skip, grayscale, resize."""

    def __init__(
        self,
        env: gym.Env,
        noop_max: int = 30,
        frame_skip: int = 4,
        screen_size: int | tuple[int, int] = 84,
        terminal_on_life_loss: bool = False,
        grayscale_obs: bool = True,
        grayscale_newaxis: bool = False,
        scale_obs: bool = False,
    ):
        RecordConstructorArgs.__init__(
            self,
            noop_max=noop_max,
            frame_skip=frame_skip,
            screen_size=screen_size,
            terminal_on_life_loss=terminal_on_life_loss,
            grayscale_obs=grayscale_obs,
            grayscale_newaxis=grayscale_newaxis,
            scale_obs=scale_obs,
        )
        gym.Wrapper.__init__(self, env)

        assert frame_skip > 0
        assert noop_max >= 0
        if frame_skip > 1:
            if (
                env.spec is not None
                and "NoFrameskip" not in env.spec.id
                and getattr(env.unwrapped, "_frameskip", None) != 1
            ):
                raise ValueError(
                    "Disable frame-skipping in the original env. Otherwise, more than one frame-skip will happen as through this wrapper"
                )
        self.noop_max = noop_max
        assert env.unwrapped.action_space.start == 0, "No-op should be action 0."

        self.frame_skip = frame_skip
        if isinstance(screen_size, int):
            screen_size = (screen_size, screen_size)
        assert isinstance(screen_size, tuple) and len(screen_size) == 2
        assert screen_size[0] > 0 and screen_size[1] > 0
        self.screen_size = screen_size
        self.terminal_on_life_loss = terminal_on_life_loss
        self.grayscale_obs = grayscale_obs
        self.grayscale_newaxis = grayscale_newaxis
        self.scale_obs = scale_obs

        # buffer of most recent two observations for max pooling
        assert isinstance(env.observation_space, spaces.Box)
        if grayscale_obs:
            self.obs_buffer = [
                np.empty(env.observation_space.shape[:2], dtype=np.uint8),
                np.empty(env.observation_space.shape[:2], dtype=np.uint8),
            ]
        else:
            self.obs_buffer = [
                np.empty(env.observation_space.shape, dtype=np.uint8),
                np.empty(env.observation_space.shape, dtype=np.uint8),
            ]

        self.lives = 0
        self.game_over = False

        _low, _high, _obs_dtype = (0, 255, np.uint8) if not scale_obs else (0, 1, np.float32)
        _shape = (screen_size[1], screen_size[0], 1 if grayscale_obs else 3)
        if grayscale_obs and not grayscale_newaxis:
            _shape = _shape[:-1]
        self.observation_space = spaces.Box(low=_low, high=_high, shape=_shape, dtype=_obs_dtype)

    @property
    def ale(self):
        """The underlying ALE interface, when present."""
        return getattr(self.env.unwrapped, "ale", None)

    def _get_lives(self) -> int:
        ale = self.ale
        if ale is not None:
            return ale.lives()
        return 0

    def step(self, action):
        """Apply frame-skip with max-pool and preprocessing."""
        total_reward, terminated, truncated, info = 0.0, False, False, {}

        for t in range(self.frame_skip):
            _, reward, terminated, truncated, info = self.env.step(action)
            total_reward += float(reward)
            self.game_over = terminated

            if self.terminal_on_life_loss:
                new_lives = self._get_lives()
                terminated = terminated or new_lives < self.lives
                self.game_over = terminated
                self.lives = new_lives

            if terminated or truncated:
                break
            if t == self.frame_skip - 2:
                self._fetch_screen(0)
            elif t == self.frame_skip - 1:
                self._fetch_screen(1)
        return self._get_obs(), total_reward, terminated, truncated, info

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        """Reset with up to ``noop_max`` random no-op actions."""
        _, reset_info = self.env.reset(seed=seed, options=options)

        noops = (
            self.env.unwrapped.np_random.integers(1, self.noop_max + 1)
            if self.noop_max > 0
            else 0
        )
        for _ in range(noops):
            _, _, terminated, truncated, step_info = self.env.step(0)
            reset_info.update(step_info)
            if terminated or truncated:
                _, reset_info = self.env.reset(seed=seed, options=options)

        self.lives = self._get_lives()
        self._fetch_screen(0)
        self.obs_buffer[1].fill(0)
        return self._get_obs(), reset_info

    def _fetch_screen(self, index: int):
        """Grab the current screen (via ALE when present, else render)."""
        ale = self.ale
        if ale is not None:
            if self.grayscale_obs:
                ale.getScreenGrayscale(self.obs_buffer[index])
            else:
                ale.getScreenRGB(self.obs_buffer[index])
            return
        frame = self.env.render()
        assert isinstance(frame, np.ndarray), (
            "AtariPreprocessing needs an ALE interface or an rgb_array render mode"
        )
        if self.grayscale_obs:
            frame = np.sum(
                frame * np.array([0.2125, 0.7154, 0.0721]), axis=-1
            ).astype(np.uint8)
        self.obs_buffer[index][...] = frame

    def _get_obs(self):
        from gymnasium_tpu_torch.wrappers.transform_observation import _resize_image

        if self.frame_skip > 1:
            np.maximum(self.obs_buffer[0], self.obs_buffer[1], out=self.obs_buffer[0])
        obs = _resize_image(self.obs_buffer[0], (self.screen_size[1], self.screen_size[0]))
        if self.scale_obs:
            obs = np.asarray(obs, dtype=np.float32) / 255.0
        else:
            obs = np.asarray(obs, dtype=np.uint8)
        if self.grayscale_obs and self.grayscale_newaxis:
            obs = np.expand_dims(obs, axis=-1)
        return obs
