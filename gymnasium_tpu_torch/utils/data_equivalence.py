"""Recursive exact-equality check over nested data structures (copy of the
JAX package's ``utils/data_equivalence.py``).

Numpy compares a JAX device array by itself, but not a tensor on the card:
two tensors compare as their host arrays, read back through
:func:`~gymnasium_tpu_torch.utils.device.to_host`.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["data_equivalence"]


def data_equivalence(data_1: Any, data_2: Any, exact: bool = False) -> bool:
    """Whether two (possibly nested) data structures are equivalent.

    With ``exact=False`` (the default, reference env_checker.py:33) float
    arrays compare with a small absolute tolerance; ``exact=True`` compares
    bit-for-bit.
    """
    if type(data_1) is not type(data_2):
        return False
    if isinstance(data_1, torch.Tensor):
        return data_equivalence(to_host(data_1), to_host(data_2), exact)
    if isinstance(data_1, dict):
        return data_1.keys() == data_2.keys() and all(
            data_equivalence(data_1[k], data_2[k], exact) for k in data_1.keys()
        )
    if isinstance(data_1, (tuple, list)):
        return len(data_1) == len(data_2) and all(
            data_equivalence(o_1, o_2, exact) for o_1, o_2 in zip(data_1, data_2)
        )
    if isinstance(data_1, np.ndarray):
        if data_1.shape != data_2.shape or data_1.dtype != data_2.dtype:
            return False
        if data_1.dtype == object:
            return all(
                data_equivalence(a, b, exact) for a, b in zip(data_1.flat, data_2.flat)
            )
        if exact:
            return bool(np.all(data_1 == data_2))
        return bool(np.allclose(data_1, data_2, atol=0.00001))
    return data_1 == data_2
