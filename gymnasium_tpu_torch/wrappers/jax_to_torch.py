"""JaxToTorch (counterpart of the JAX package's ``wrappers/jax_to_torch.py``).

Parity surface: reference gymnasium/wrappers/jax_to_torch.py:49. The port
has no JAX array to convert: each name keeps its signature and raises
:class:`~gymnasium_tpu_torch.error.DependencyNotInstalled` when called. A
numpy env of the port is read as torch through ``NumpyToTorch(env, device)``.
"""

from __future__ import annotations

from typing import Any

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.wrappers.array_conversion import ArrayConversion, jax_not_installed

__all__ = ["JaxToTorch", "jax_to_torch", "torch_to_jax"]


def jax_to_torch(value: Any) -> Any:
    """Convert a (possibly nested) jax structure to torch."""
    raise jax_not_installed("`jax_to_torch`")


def torch_to_jax(value: Any) -> Any:
    """Convert a (possibly nested) torch structure to jax."""
    raise jax_not_installed("`torch_to_jax`")


class JaxToTorch(ArrayConversion):
    """Wraps a jax env so actions/observations are torch tensors."""

    def __init__(self, env: gym.Env, device: Any = None):
        raise jax_not_installed("`JaxToTorch`")
