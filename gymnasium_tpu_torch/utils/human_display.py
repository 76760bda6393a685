"""Display numpy RGB frames in a window for ``human`` render mode.

Uses pygame when available (the only native display dependency, never on the
compute path); raises DependencyNotInstalled otherwise.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch import error

__all__ = ["HumanDisplay"]


class HumanDisplay:
    """Owns a window + clock and blits numpy RGB frames at a target fps."""

    def __init__(self, width: int, height: int, fps: int, caption: str = "gymnasium_tpu_torch"):
        try:
            import pygame
        except ImportError as e:
            raise error.DependencyNotInstalled(
                'pygame is not installed, run `pip install "pygame"` to use human render mode'
            ) from e
        self._pygame = pygame
        pygame.init()
        pygame.display.init()
        pygame.display.set_caption(caption)
        self.window = pygame.display.set_mode((width, height))
        self.clock = pygame.time.Clock()
        self.fps = fps

    def show(self, frame: np.ndarray) -> None:
        """Blit a ``(H, W, 3)`` uint8 frame and tick the clock."""
        pygame = self._pygame
        surface = pygame.surfarray.make_surface(np.transpose(frame, (1, 0, 2)))
        self.window.blit(surface, (0, 0))
        pygame.event.pump()
        self.clock.tick(self.fps)
        pygame.display.flip()

    def close(self) -> None:
        self._pygame.display.quit()
        self._pygame.quit()
