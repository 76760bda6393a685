"""Vector-level array-conversion wrappers (copy of the JAX package's
``wrappers/vector/array_conversion.py``).

Parity surface: reference gymnasium/wrappers/vector/ array conversion
mirrors (JaxToNumpy, JaxToTorch, NumpyToTorch). Over a ``TorchVectorEnv``,
``ArrayConversion(envs, "torch", "numpy")`` reads each batch back from the
card once a step; ``NumpyToTorch(envs, device)`` puts each batch on
``device``. The jax-named wrappers raise
:class:`~gymnasium_tpu_torch.error.DependencyNotInstalled`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch.vector.vector_env import VectorEnv, VectorWrapper
from gymnasium_tpu_torch.wrappers.array_conversion import (
    array_conversion,
    jax_not_installed,
    module_namespace,
)

__all__ = ["ArrayConversion", "JaxToNumpy", "JaxToTorch", "NumpyToTorch"]


class ArrayConversion(VectorWrapper):
    """Convert batched actions/results between array frameworks."""

    def __init__(self, env: VectorEnv, env_xp, target_xp):
        super().__init__(env)
        self._env_xp = module_namespace(env_xp) if isinstance(env_xp, str) else env_xp
        self._target_xp = (
            module_namespace(target_xp) if isinstance(target_xp, str) else target_xp
        )
        # where the tensors handed out lie; NumpyToTorch sets it
        self._target_device = None

    def step(self, actions):
        actions = array_conversion(actions, self._env_xp)
        obs, reward, terminated, truncated, info = self.env.step(actions)
        return tuple(
            array_conversion(value, self._target_xp, self._target_device)
            for value in (obs, reward, terminated, truncated, info)
        )

    def reset(self, *, seed: int | list[int] | None = None, options: dict[str, Any] | None = None):
        if options:
            options = array_conversion(options, self._env_xp)
        obs, info = self.env.reset(seed=seed, options=options)
        return (
            array_conversion(obs, self._target_xp, self._target_device),
            array_conversion(info, self._target_xp, self._target_device),
        )


class JaxToNumpy(ArrayConversion):
    """Batched jax env exposed through numpy arrays."""

    def __init__(self, env: VectorEnv):
        raise jax_not_installed("`vector.JaxToNumpy`")


class JaxToTorch(ArrayConversion):
    """Batched jax env exposed through torch tensors."""

    def __init__(self, env: VectorEnv, device: Any = None):
        raise jax_not_installed("`vector.JaxToTorch`")


class NumpyToTorch(ArrayConversion):
    """Batched numpy env exposed through torch tensors on ``device``
    (``None``: the CPU)."""

    def __init__(self, env: VectorEnv, device: Any = None):
        super().__init__(env, env_xp=np, target_xp=torch)
        self._target_device = device

    @property
    def device(self) -> Any:
        """The device the tensors handed out lie on (``None``: the CPU)."""
        return self._target_device
