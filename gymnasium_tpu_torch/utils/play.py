"""Interactive keyboard-driven play loop.

Copy of the JAX package's ``utils/play.py``. Parity surface: reference
gymnasium/utils/play.py:43-380 (``play``, ``PlayableGame``, ``PlayPlot``).
Requires pygame (display) and, for ``PlayPlot``, matplotlib; both imported
lazily. The port's envs render host numpy frames; a plotted point that is
a tensor is read back through :func:`~gymnasium_tpu_torch.utils.device.to_host`.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable

import numpy as np
import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.error import DependencyNotInstalled
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["play", "PlayableGame", "PlayPlot", "display_arr"]


class MissingKeysToAction(Exception):
    """Raised when the env has no keys_to_action mapping."""


class PlayableGame:
    """Tracks pygame key state for an env being played."""

    def __init__(
        self,
        env: gym.Env,
        keys_to_action: dict[tuple[Any, ...], Any] | None = None,
        zoom: float | None = None,
    ):
        if env.render_mode not in {"rgb_array", "rgb_array_list"}:
            raise ValueError(
                f"PlayableGame wrapper works only with rgb_array and rgb_array_list render modes, but your environment render_mode = {env.render_mode}."
            )
        try:
            import pygame
        except ImportError as e:
            raise DependencyNotInstalled("pygame is not installed") from e

        self._pygame = pygame
        self.env = env
        self.relevant_keys = self._get_relevant_keys(keys_to_action)
        self.video_size = self._get_video_size(zoom)
        self.screen = pygame.display.set_mode(self.video_size)
        self.pressed_keys: list[Any] = []
        self.running = True

    def _get_relevant_keys(self, keys_to_action=None) -> set:
        if keys_to_action is None:
            if hasattr(self.env, "get_keys_to_action"):
                keys_to_action = self.env.get_keys_to_action()
            elif hasattr(self.env.unwrapped, "get_keys_to_action"):
                keys_to_action = self.env.unwrapped.get_keys_to_action()
            else:
                raise MissingKeysToAction(
                    f"{self.env.spec.id} does not have explicit key to action mapping, please specify one manually"
                )
        assert isinstance(keys_to_action, dict)
        relevant_keys = set(sum((list(k) for k in keys_to_action.keys()), []))
        return relevant_keys

    def _get_video_size(self, zoom: float | None = None) -> tuple[int, int]:
        rendered = self.env.render()
        if isinstance(rendered, list):
            rendered = rendered[-1]
        assert rendered is not None and isinstance(rendered, np.ndarray)
        video_size = (rendered.shape[1], rendered.shape[0])
        if zoom is not None:
            video_size = (int(video_size[0] * zoom), int(video_size[1] * zoom))
        return video_size

    def process_event(self, event) -> None:
        """Update pressed-key state from a pygame event."""
        pygame = self._pygame
        if event.type == pygame.KEYDOWN:
            if event.key in self.relevant_keys:
                self.pressed_keys.append(event.key)
            elif event.key == pygame.K_ESCAPE:
                self.running = False
        elif event.type == pygame.KEYUP:
            if event.key in self.relevant_keys:
                self.pressed_keys.remove(event.key)
        elif event.type == pygame.QUIT:
            self.running = False


def display_arr(screen, arr: np.ndarray, video_size: tuple[int, int], transpose: bool):
    """Blit a numpy frame onto a pygame surface."""
    import pygame

    arr_min, arr_max = np.min(arr), np.max(arr)
    arr = 255.0 * (arr - arr_min) / (arr_max - arr_min)
    pyg_img = pygame.surfarray.make_surface(arr.swapaxes(0, 1) if transpose else arr)
    pyg_img = pygame.transform.scale(pyg_img, video_size)
    screen.blit(pyg_img, (0, 0))


def play(
    env: gym.Env,
    transpose: bool | None = True,
    fps: int | None = None,
    zoom: float | None = None,
    callback: Callable | None = None,
    keys_to_action: dict[tuple[Any, ...] | str, Any] | None = None,
    seed: int | None = None,
    noop: Any = 0,
    wait_on_player: bool = False,
):
    """Play an environment using the keyboard.

    ``keys_to_action`` maps tuples of pressed keys (or strings of their
    characters) to actions; unmapped combinations produce ``noop``.
    """
    try:
        import pygame
    except ImportError as e:
        raise DependencyNotInstalled("pygame is not installed") from e

    env.reset(seed=seed)

    if keys_to_action is None:
        if hasattr(env, "get_keys_to_action"):
            keys_to_action = env.get_keys_to_action()
        elif hasattr(env.unwrapped, "get_keys_to_action"):
            keys_to_action = env.unwrapped.get_keys_to_action()
        else:
            assert env.spec is not None
            raise MissingKeysToAction(
                f"{env.spec.id} does not have explicit key to action mapping, please specify one manually"
            )
    assert keys_to_action is not None

    key_code_to_action = {}
    for key_combination, action in keys_to_action.items():
        # a bare int key means a single-key combination (reference play.py)
        if isinstance(key_combination, int):
            key_combination = (key_combination,)
        key_code = tuple(
            sorted(ord(key) if isinstance(key, str) else key for key in key_combination)
        )
        key_code_to_action[key_code] = action

    game = PlayableGame(env, key_code_to_action, zoom)

    if fps is None:
        fps = env.metadata.get("render_fps", 30)

    done, obs = True, None
    clock = pygame.time.Clock()

    while game.running:
        if done:
            done = False
            obs = env.reset(seed=seed)[0]
        else:
            action = key_code_to_action.get(tuple(sorted(game.pressed_keys)), noop)
            prev_obs = obs
            obs, rew, terminated, truncated, info = env.step(action)
            done = terminated or truncated
            if callback is not None:
                callback(prev_obs, obs, action, rew, terminated, truncated, info)
        if obs is not None:
            rendered = env.render()
            if isinstance(rendered, list):
                rendered = rendered[-1]
            if rendered is not None and isinstance(rendered, np.ndarray):
                display_arr(game.screen, rendered, transpose=transpose, video_size=game.video_size)

        for event in pygame.event.get():
            game.process_event(event)

        pygame.display.flip()
        clock.tick(fps)
    pygame.quit()


class PlayPlot:
    """Plot a rolling window of per-step statistics during play."""

    def __init__(self, callback: Callable, horizon_timesteps: int, plot_names: list[str]):
        self.data_callback = callback
        self.horizon_timesteps = horizon_timesteps
        self.plot_names = plot_names

        try:
            import matplotlib.pyplot as plt
        except ImportError as e:
            raise DependencyNotInstalled("matplotlib is not installed") from e

        self._plt = plt
        num_plots = len(plot_names)
        self.fig, self.ax = plt.subplots(num_plots)
        if num_plots == 1:
            self.ax = [self.ax]
        for axis, name in zip(self.ax, plot_names):
            axis.set_title(name)
        self.t = 0
        self.cur_plot: list[Any] = [None for _ in range(num_plots)]
        self.data = [deque(maxlen=horizon_timesteps) for _ in range(num_plots)]

    def callback(self, obs_t, obs_tp1, action, rew, terminated, truncated, info):
        """Feed one transition into the plots."""
        points = self.data_callback(obs_t, obs_tp1, action, rew, terminated, truncated, info)
        for point, data_series in zip(points, self.data):
            # a device env's observations are tensors, which matplotlib cannot read
            data_series.append(to_host(point) if isinstance(point, torch.Tensor) else point)
        self.t += 1

        xmin, xmax = max(0, self.t - self.horizon_timesteps), self.t
        for i, plot in enumerate(self.cur_plot):
            if plot is not None:
                plot.remove()
            self.cur_plot[i] = self.ax[i].scatter(
                range(xmin, xmax), list(self.data[i]), c="blue"
            )
            self.ax[i].set_xlim(xmin, xmax)
        self._plt.pause(0.000001)
