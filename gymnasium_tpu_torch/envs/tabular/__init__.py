"""Tabular and card-game functional envs."""

from gymnasium_tpu_torch.envs.tabular.blackjack import BlackjackFunctional
from gymnasium_tpu_torch.envs.tabular.cliffwalking import CliffWalkingFunctional
from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.tabular.frozen_lake import FrozenLake8x8Functional, FrozenLakeFunctional
from gymnasium_tpu_torch.envs.tabular.taxi import TaxiFunctional

__all__ = [
    "BlackjackFunctional",
    "CliffWalkingFunctional",
    "FrozenLake8x8Functional",
    "FrozenLakeFunctional",
    "TabularFuncEnv",
    "TaxiFunctional",
]
