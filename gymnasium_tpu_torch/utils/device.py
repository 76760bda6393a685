"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

__all__ = ["batch_to_host", "resolve_device", "to_host", "upload_row"]


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means CUDA. Without a CUDA device that raises: the port never
    falls back to the CPU unless the caller asks for it with ``device="cpu"``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} was requested but CUDA is not available")
    return device


def upload_row(device: torch.device, *parts) -> torch.Tensor:
    """Host values ``parts`` (numbers and arrays, flattened in order) as one
    ``(1, n)`` float32 row on ``device``: one copy from the host."""
    row = np.concatenate([np.asarray(p, dtype=np.float64).ravel() for p in parts]).astype(np.float32)
    return torch.from_numpy(row[None]).to(device)


def to_host(x: Any) -> np.ndarray:
    """``x`` as a host numpy array: a tensor read back from its device (one
    copy), anything else through ``np.asarray``. Host code that the JAX
    package hands device arrays to, where numpy would read them itself,
    takes a tensor through this."""
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def batch_to_host(batch: Any) -> Any:
    """``batch`` with each tensor in it read back by :func:`to_host`: dicts
    and tuples (named ones too) entry by entry, every other entry kept as it
    is, so a host batch comes back unchanged."""
    if isinstance(batch, torch.Tensor):
        return to_host(batch)
    if isinstance(batch, dict):
        return {key: batch_to_host(value) for key, value in batch.items()}
    if isinstance(batch, tuple):
        items = [batch_to_host(value) for value in batch]
        return type(batch)(*items) if hasattr(batch, "_fields") else tuple(items)
    return batch
