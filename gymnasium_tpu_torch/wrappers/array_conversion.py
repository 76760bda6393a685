"""Cross-framework array conversion wrappers (copy of the JAX package's
``wrappers/array_conversion.py``).

Parity surface: reference gymnasium/wrappers/array_conversion.py:156 — a
generic converter between array frameworks, without the array-api-compat
dependency: conversions dispatch on module pairs.

In the port a device array is a torch tensor, so the namespaces are numpy
and torch. A tensor reaches numpy through
:func:`~gymnasium_tpu_torch.utils.device.to_host`, from whatever device it
lies on, and a conversion to torch puts the tensor on the wrapper's device
(``None``: the CPU). The names that mean JAX raise
:class:`~gymnasium_tpu_torch.error.DependencyNotInstalled` without importing
it, as the JAX package does on a machine without JAX.
"""

from __future__ import annotations

import functools
import numbers
from collections import abc
from typing import Any, Mapping

import numpy as np
import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.core import RenderFrame, WrapperActType
from gymnasium_tpu_torch.error import DependencyNotInstalled
from gymnasium_tpu_torch.utils import RecordConstructorArgs
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["ArrayConversion", "module_namespace", "array_conversion"]

JAX_NAMESPACES = ("jax", "jax.numpy", "jnp")


def jax_not_installed(what: str) -> DependencyNotInstalled:
    """The error of a name that needs JAX, which the port never imports."""
    return DependencyNotInstalled(
        f"{what} needs JAX, which the torch port does not use: its device arrays are torch tensors. "
        'Wrap a device env in `ArrayConversion(env, env_xp="torch", target_xp="numpy")`, '
        "or a numpy env in `NumpyToTorch(env, device)`."
    )


def module_namespace(xp_name: str):
    """The array namespace for ``"numpy"`` or ``"torch"``."""
    if xp_name in ("numpy", "np"):
        return np
    if xp_name in JAX_NAMESPACES:
        raise jax_not_installed(f"The array namespace {xp_name!r}")
    if xp_name == "torch":
        return torch
    raise ValueError(f"Unknown array namespace: {xp_name}")


def _namespace_name(xp) -> str:
    return "torch" if "torch" in getattr(xp, "__name__", str(xp)) else "numpy"


def _from_numpy(value: np.ndarray, xp, device=None):
    if _namespace_name(xp) == "torch":
        # NOT np.ascontiguousarray: it promotes 0-d arrays to 1-d, breaking
        # scalar-tensor roundtrips. as_tensor copies when layout requires.
        return torch.as_tensor(np.asarray(value), device=device)
    return np.asarray(value)


@functools.singledispatch
def array_conversion(value: Any, xp, device=None) -> Any:
    """Convert ``value`` (array or nested container) into namespace ``xp``;
    a tensor made for torch lies on ``device`` (``None``: the CPU)."""
    if value is None:
        return None
    if hasattr(value, "__array__") or isinstance(value, torch.Tensor):
        return _from_numpy(to_host(value), xp, device)
    return value


@array_conversion.register(abc.Mapping)
def _mapping_conversion(value: Mapping[str, Any], xp, device=None) -> Mapping[str, Any]:
    return type(value)(**{k: array_conversion(v, xp, device) for k, v in value.items()})


@array_conversion.register(tuple)
def _tuple_conversion(value, xp, device=None):
    if hasattr(value, "_fields"):  # NamedTuple
        return type(value)(*(array_conversion(v, xp, device) for v in value))
    return tuple(array_conversion(v, xp, device) for v in value)


@array_conversion.register(list)
def _list_conversion(value, xp, device=None):
    return [array_conversion(v, xp, device) for v in value]


@array_conversion.register(numbers.Number)
def _number_conversion(value, xp, device=None):
    if _namespace_name(xp) == "numpy":
        return value
    # torch's own scalar rules (float -> float32, int -> int64) so a
    # python-float -> torch -> numpy roundtrip yields float32
    return torch.as_tensor(value, device=device)


class ArrayConversion(gym.Wrapper, RecordConstructorArgs):
    """Convert actions from / results to a target array framework.

    The env itself operates in ``env_xp`` arrays; the user sees ``target_xp``
    arrays. E.g. ``ArrayConversion(env, env_xp="torch", target_xp="numpy")``
    reads a device env's tensors back as numpy.

    Inherits ``RecordConstructorArgs`` (as the reference does,
    array_conversion.py:156) so the wrapper appears reconstructibly in
    ``EnvSpec.additional_wrappers``.
    """

    def __init__(self, env: gym.Env, env_xp, target_xp):
        RecordConstructorArgs.__init__(
            self, env_xp=env_xp, target_xp=target_xp, _disable_deepcopy=True
        )
        gym.Wrapper.__init__(self, env)
        self._env_xp = module_namespace(env_xp) if isinstance(env_xp, str) else env_xp
        self._target_xp = module_namespace(target_xp) if isinstance(target_xp, str) else target_xp
        # where the tensors handed out lie; NumpyToTorch sets it
        self._target_device = None

    def step(self, action: WrapperActType):
        env_action = array_conversion(action, self._env_xp)
        obs, reward, terminated, truncated, info = self.env.step(env_action)
        return (
            array_conversion(obs, self._target_xp, self._target_device),
            float(reward),
            bool(terminated),
            bool(truncated),
            array_conversion(info, self._target_xp, self._target_device),
        )

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        if options:
            options = array_conversion(options, self._env_xp)
        obs, info = self.env.reset(seed=seed, options=options)
        return (
            array_conversion(obs, self._target_xp, self._target_device),
            array_conversion(info, self._target_xp, self._target_device),
        )

    def render(self) -> RenderFrame | list[RenderFrame] | None:
        return self.env.render()

    def __getstate__(self):
        """Pickle by namespace NAME — module objects are unpicklable
        (reference array_conversion.py:261-273) — and the target device by
        its name."""
        return {
            "env_xp_name": _namespace_name(self._env_xp),
            "target_xp_name": _namespace_name(self._target_xp),
            "target_device": None if self._target_device is None else str(self._target_device),
            "env": self.env,
        }

    def __setstate__(self, d):
        """Restore namespaces by re-importing them from their names; the
        Wrapper base state (lazy space/metadata overrides) re-initializes."""
        self._env_xp = module_namespace(d["env_xp_name"])
        self._target_xp = module_namespace(d["target_xp_name"])
        self._target_device = d["target_device"]
        gym.Wrapper.__init__(self, d["env"])
