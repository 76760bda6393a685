"""Taxi as a tabular functional env.

Counterpart of ``TaxiFunctional`` in the JAX package's ``envs/tabular/taxi.py``.
"""

from __future__ import annotations

from typing import Any

from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.toy_text.taxi import build_taxi_model

__all__ = ["TaxiFunctional"]


class TaxiFunctional(TabularFuncEnv):
    """Taxi (500 states, 6 actions). Option ``is_rainy``; ``fickle_passenger``
    is accepted and dropped, as in JAX: the host env's post-step rewrite lies
    outside the MDP tensors."""

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        is_rainy = options.pop("is_rainy", False)
        options.pop("fickle_passenger", None)
        super().__init__(build_taxi_model(is_rainy), options)
