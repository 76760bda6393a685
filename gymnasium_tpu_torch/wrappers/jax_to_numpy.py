"""JaxToNumpy (counterpart of the JAX package's ``wrappers/jax_to_numpy.py``).

Parity surface: reference gymnasium/wrappers/jax_to_numpy.py:33. The port
has no JAX array to convert: each name keeps its signature and raises
:class:`~gymnasium_tpu_torch.error.DependencyNotInstalled` when called. A
device env of the port is read as numpy through
``ArrayConversion(env, env_xp="torch", target_xp="numpy")``.
"""

from __future__ import annotations

from typing import Any

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.wrappers.array_conversion import ArrayConversion, jax_not_installed

__all__ = ["JaxToNumpy", "jax_to_numpy", "numpy_to_jax"]


def jax_to_numpy(value: Any) -> Any:
    """Convert a (possibly nested) jax structure to numpy."""
    raise jax_not_installed("`jax_to_numpy`")


def numpy_to_jax(value: Any) -> Any:
    """Convert a (possibly nested) numpy structure to jax."""
    raise jax_not_installed("`numpy_to_jax`")


class JaxToNumpy(ArrayConversion):
    """Wraps a jax env so actions/observations are numpy arrays."""

    def __init__(self, env: gym.Env):
        raise jax_not_installed("`JaxToNumpy`")
