"""Random draws from an explicit ``torch.Generator``, as JAX's samplers make them.

Every draw is made on the generator's device (or ``device``), so a batch on
the card never waits for the host.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["categorical", "gumbel", "uniform_map"]


def gumbel(generator: torch.Generator, shape, device=None) -> torch.Tensor:
    """Standard Gumbel draws, ``-log(-log(u))`` with ``u`` clamped away from 0."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Sample one index per row of ``logits`` by the Gumbel-max trick, as
    ``jax.random.categorical`` does, from an explicit generator."""
    return torch.argmax(logits + gumbel(generator, logits.shape, logits.device), dim=-1)


def uniform_map(u: torch.Tensor, low: float, high: float) -> torch.Tensor:
    """``U[low, high)`` from draws ``u ~ U[0, 1)``, rounded as
    ``jax.random.uniform(minval=low, maxval=high)`` rounds its uniforms:
    ``max(low, u * (high - low) + low)`` in float32."""
    lo = np.float32(low)
    return torch.clamp(u * float(np.float32(high) - lo) + float(lo), min=float(lo))
