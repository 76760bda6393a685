"""The PPO policy network of the torch port, and weights carried over from JAX.

Counterpart of ``_mlp_init``/``_mlp_apply`` and the parameter tree of
``init_ppo`` in the JAX package's ``train/ppo.py``: an orthogonally
initialised tanh MLP whose hidden layers run in ``compute_dtype`` (bf16 by
default) and whose final layer takes ``compute_dtype`` operands but
accumulates and returns float32, because logits feed a log-softmax where bf16
resolution would bite. :class:`ActorCritic` holds the policy and value MLPs
and, for Box actions, the state-independent ``log_std``.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gymnasium_tpu_torch.utils.draws import categorical

__all__ = [
    "MLP",
    "ActorCritic",
    "categorical",
    "mlp_from_jax_params",
    "ppo_params_from_jax",
    "wrapper_states_from_jax",
]


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


class ActorCritic(nn.Module):
    """The PPO parameters: ``pi`` (logits or Gaussian means), ``v`` (the
    value) and, for continuous actions, ``log_std``, a zero-initialised
    parameter of the action's width."""

    def __init__(
        self,
        obs_dim: int,
        hidden_sizes: Sequence[int],
        act_out: int,
        continuous: bool,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        sizes = (obs_dim, *hidden_sizes)
        self.pi = MLP((*sizes, act_out), compute_dtype, generator)
        self.v = MLP((*sizes, 1), compute_dtype, generator)
        self.log_std = nn.Parameter(torch.zeros(act_out)) if continuous else None

    @property
    def continuous(self) -> bool:
        return self.log_std is not None


def ppo_params_from_jax(params, compute_dtype: torch.dtype = torch.bfloat16) -> ActorCritic:
    """Build an :class:`ActorCritic` from the JAX ``{"pi", "v"[, "log_std"]}`` tree
    of ``init_ppo`` (numpy arrays)."""
    pi = mlp_from_jax_params(params["pi"], compute_dtype)
    v = mlp_from_jax_params(params["v"], compute_dtype)
    continuous = "log_std" in params
    sizes = [layer.in_features for layer in pi.layers]
    policy = ActorCritic(sizes[0], sizes[1:], pi.layers[-1].out_features, continuous, compute_dtype)
    policy.pi, policy.v = pi, v
    if continuous:
        with torch.no_grad():
            policy.log_std.copy_(torch.tensor(np.asarray(params["log_std"], dtype=np.float32)))
    return policy


def wrapper_states_from_jax(states, device: str | torch.device = "cpu"):
    """The port's wrapper states from JAX ones (``RmsState``,
    ``NormalizeRewardState``, ``EpisodeStatsState``, ``None``, or tuples of
    them, with numpy or JAX array leaves), each leaf keeping its dtype."""
    from gymnasium_tpu_torch.wrappers import func

    def convert(x):
        if x is None:
            return None
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return getattr(func, type(x).__name__)(*(convert(c) for c in x))
        if isinstance(x, (tuple, list)):
            return type(x)(convert(c) for c in x)
        return torch.from_numpy(np.array(x)).to(device)

    return convert(states)
