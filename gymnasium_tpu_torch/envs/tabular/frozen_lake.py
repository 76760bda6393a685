"""FrozenLake as a tabular functional env.

Counterpart of ``FrozenLakeFunctional`` and ``FrozenLake8x8Functional`` in
the JAX package's ``envs/tabular/frozen_lake.py``.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.toy_text.frozen_lake import MAPS, build_frozen_lake_model

__all__ = ["FrozenLakeFunctional", "FrozenLake8x8Functional"]


class FrozenLakeFunctional(TabularFuncEnv):
    """FrozenLake (4x4 by default). Options: ``map_name``, ``desc``,
    ``is_slippery``, ``success_rate``, ``reward_schedule``."""

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        map_name = options.pop("map_name", "4x4")
        desc = options.pop("desc", None)
        is_slippery = options.pop("is_slippery", True)
        success_rate = options.pop("success_rate", 1.0 / 3.0)
        reward_schedule = options.pop("reward_schedule", (1, 0, 0))
        if desc is None:
            desc = MAPS[map_name]
        desc = np.asarray(desc, dtype="c")
        model = build_frozen_lake_model(desc, is_slippery, success_rate, reward_schedule)
        super().__init__(model, options)
        self.desc = desc


class FrozenLake8x8Functional(FrozenLakeFunctional):
    """FrozenLake on the 8x8 board."""

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        options.setdefault("map_name", "8x8")
        super().__init__(options)
