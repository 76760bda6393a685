"""Conversion between the old done-based and new terminated/truncated step APIs
(copy of the JAX package's ``utils/step_api_compatibility.py``).

Parity surface: reference gymnasium/utils/step_api_compatibility.py:27-138.
Behavior contract (pinned by the reference's test suite):

- old -> new recovers truncation from the ``"TimeLimit.truncated"`` info key
  (popped; absent means not truncated);
- new -> old records ``"TimeLimit.truncated"`` in the info whenever the
  episode ended — including ``False`` on pure termination — so the two
  conversions round-trip;
- vector envs carry infos either as a list of per-env dicts or as one
  batched dict; both layouts are handled.

A vector env's flags may be tensors on the card (``TorchVectorEnv``); the
vector forms read them back through
:func:`~gymnasium_tpu_torch.utils.device.to_host` where the JAX package lets
numpy read its device arrays, so their flags come back as numpy.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np

from gymnasium_tpu_torch.utils.device import to_host

__all__ = [
    "convert_to_terminated_truncated_step_api",
    "convert_to_done_step_api",
    "step_api_compatibility",
]

DoneStepType = Tuple[
    Union[dict, np.ndarray],
    Union[float, np.ndarray],
    Union[bool, np.ndarray],
    Union[dict, list],
]
TerminatedTruncatedStepType = Tuple[
    Union[dict, np.ndarray],
    Union[float, np.ndarray],
    Union[bool, np.ndarray],
    Union[bool, np.ndarray],
    Union[dict, list],
]

_FLAG = "TimeLimit.truncated"


def _bad_infos(infos) -> TypeError:
    return TypeError(
        f"Vector-env infos must be a list of dicts or a batched dict, "
        f"got {type(infos)}"
    )


def convert_to_terminated_truncated_step_api(step_returns, is_vector_env: bool = False):
    """Convert a 4-tuple ``(obs, reward, done, info)`` to the 5-tuple API.

    The ``"TimeLimit.truncated"`` flag is popped out of the info to split
    ``done`` into terminated/truncated (reference
    step_api_compatibility.py:27-78).
    """
    if len(step_returns) == 5:
        return step_returns
    assert len(step_returns) == 4
    obs, reward, done, infos = step_returns

    if not is_vector_env:
        was_truncation = bool(infos.pop(_FLAG, False))
        return obs, reward, done and not was_truncation, done and was_truncation, infos

    # vector form: build the per-env truncation-flag array from either layout
    if isinstance(infos, list):
        flags = np.asarray([bool(d.pop(_FLAG, False)) for d in infos], dtype=bool)
    elif isinstance(infos, dict):
        flags = to_host(infos.pop(_FLAG, np.zeros(len(done), dtype=bool)))
    else:
        raise _bad_infos(infos)
    done = to_host(done).astype(bool, copy=False)
    return obs, reward, done & ~flags, done & flags, infos


def convert_to_done_step_api(step_returns, is_vector_env: bool = False):
    """Convert a 5-tuple step return to the old 4-tuple ``done`` API.

    Writes ``"TimeLimit.truncated"`` into the info (in place) for every
    ended episode — ``False`` when it terminated — so a subsequent
    old->new conversion round-trips (reference
    step_api_compatibility.py:81-135).
    """
    if len(step_returns) == 4:
        return step_returns
    assert len(step_returns) == 5
    obs, reward, terminated, truncated, infos = step_returns

    if not is_vector_env:
        if terminated or truncated:
            infos[_FLAG] = bool(truncated) and not terminated
        return obs, reward, terminated or truncated, infos

    terminated, truncated = to_host(terminated), to_host(truncated)
    if isinstance(infos, list):
        for d, term, trunc in zip(infos, terminated, truncated, strict=True):
            if term or trunc:
                d[_FLAG] = bool(trunc) and not term
    elif isinstance(infos, dict):
        term = terminated.astype(bool, copy=False)
        trunc = truncated.astype(bool, copy=False)
        if (term | trunc).any():
            infos[_FLAG] = trunc & ~term
    else:
        raise _bad_infos(infos)
    return obs, reward, np.logical_or(terminated, truncated), infos


def step_api_compatibility(
    step_returns,
    output_truncation_bool: bool = True,
    is_vector_env: bool = False,
):
    """Normalize step returns to the requested API shape."""
    convert = (
        convert_to_terminated_truncated_step_api
        if output_truncation_bool
        else convert_to_done_step_api
    )
    return convert(step_returns, is_vector_env)
