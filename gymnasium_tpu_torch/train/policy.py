"""The PPO policy network of the torch port, and weights carried over from JAX.

Counterpart of ``_mlp_init``/``_mlp_apply`` in the JAX package's
``train/ppo.py``: an orthogonally initialised tanh MLP whose hidden layers
run in ``compute_dtype`` (bf16 by default) and whose final layer takes
``compute_dtype`` operands but accumulates and returns float32, because
logits feed a log-softmax where bf16 resolution would bite.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["MLP", "categorical", "mlp_from_jax_params"]


class MLP(nn.Module):
    """Tanh MLP with ``compute_dtype`` hidden activations and a float32 head."""

    def __init__(
        self,
        sizes: Sequence[int],
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.layers = nn.ModuleList(
            nn.Linear(fan_in, fan_out) for fan_in, fan_out in zip(sizes[:-1], sizes[1:])
        )
        with torch.no_grad():
            for layer in self.layers:
                nn.init.orthogonal_(layer.weight, math.sqrt(2), generator=generator)
                nn.init.zeros_(layer.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x.to(self.compute_dtype)
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            w = layer.weight.to(self.compute_dtype)
            if i == last:
                # compute_dtype operands, float32 accumulation and result:
                # a product of two bf16 values is exact in float32
                return F.linear(h.float(), w.float(), layer.bias)
            # rounded after the product and again after the bias, as in JAX
            h = torch.tanh(F.linear(h, w) + layer.bias.to(self.compute_dtype))
        raise ValueError("MLP needs at least one layer")


def mlp_from_jax_params(params, compute_dtype: torch.dtype = torch.bfloat16) -> MLP:
    """Build an :class:`MLP` from JAX ``[{"w": (fan_in, fan_out), "b": (fan_out,)}, ...]``.

    ``nn.Linear`` stores its weight as ``(out, in)``, so each ``w`` is transposed.
    """
    sizes = [np.shape(params[0]["w"])[0]] + [np.shape(layer["w"])[1] for layer in params]
    mlp = MLP(sizes, compute_dtype)
    with torch.no_grad():
        for layer, p in zip(mlp.layers, params):
            layer.weight.copy_(torch.tensor(np.asarray(p["w"], dtype=np.float32).T))
            layer.bias.copy_(torch.tensor(np.asarray(p["b"], dtype=np.float32)))
    return mlp


def categorical(generator: torch.Generator, logits: torch.Tensor) -> torch.Tensor:
    """Sample one index per row of ``logits`` by the Gumbel-max trick, as
    ``jax.random.categorical`` does, from an explicit generator."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(logits.shape, generator=generator, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(logits + gumbel, dim=-1)
