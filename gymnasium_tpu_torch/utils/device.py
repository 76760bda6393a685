"""Device selection for the port's entry points."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "upload_row"]


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
