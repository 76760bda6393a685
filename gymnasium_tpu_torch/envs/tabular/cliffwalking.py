"""CliffWalking as a tabular functional env.

Counterpart of ``CliffWalkingFunctional`` in the JAX package's
``envs/tabular/cliffwalking.py``; its rendering is not ported.
"""

from __future__ import annotations

from typing import Any

from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.toy_text.cliffwalking import build_cliffwalking_model

__all__ = ["CliffWalkingFunctional"]


class CliffWalkingFunctional(TabularFuncEnv):
    """CliffWalking (4x12). Option ``is_slippery``."""

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        is_slippery = options.pop("is_slippery", False)
        super().__init__(build_cliffwalking_model(is_slippery), options)
