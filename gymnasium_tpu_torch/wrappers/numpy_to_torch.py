"""NumpyToTorch: expose a numpy-based env through torch tensors (copy of
the JAX package's ``wrappers/numpy_to_torch.py``).

Parity surface: reference gymnasium/wrappers/numpy_to_torch.py:35. Unlike
the JAX package's, which stores ``device`` and hands back CPU tensors, the
port's puts every tensor on ``device`` (``None``: the CPU): on the card that
is what the wrapper is for.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.utils import RecordConstructorArgs
from gymnasium_tpu_torch.wrappers.array_conversion import ArrayConversion, array_conversion

__all__ = ["NumpyToTorch", "numpy_to_torch", "torch_to_numpy"]


def numpy_to_torch(value: Any) -> Any:
    """Convert a (possibly nested) numpy structure to torch."""
    return array_conversion(value, torch)


def torch_to_numpy(value: Any) -> Any:
    """Convert a (possibly nested) torch structure to numpy, reading each
    tensor back from its device."""
    return array_conversion(value, np)


class NumpyToTorch(ArrayConversion):
    """Wraps a numpy env so actions/observations are torch tensors on
    ``device``."""

    def __init__(self, env: gym.Env, device: Any = None):
        RecordConstructorArgs.__init__(self, device=device)
        super().__init__(env, env_xp=np, target_xp=torch)
        self._target_device = device

    @property
    def device(self) -> Any:
        """The device the tensors handed out lie on (``None``: the CPU)."""
        return self._target_device
