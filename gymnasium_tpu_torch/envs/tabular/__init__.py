"""Tabular and card-game functional envs, and the named adapters of
Blackjack and CliffWalking (as the JAX package's ``envs/tabular/__init__.py``
exports its ``*JaxEnv`` classes)."""

from gymnasium_tpu_torch.envs.tabular.blackjack import BlackJackTorchEnv, BlackjackFunctional
from gymnasium_tpu_torch.envs.tabular.cliffwalking import CliffWalkingFunctional, CliffWalkingTorchEnv
from gymnasium_tpu_torch.envs.tabular.core import TabularFuncEnv
from gymnasium_tpu_torch.envs.tabular.frozen_lake import FrozenLake8x8Functional, FrozenLakeFunctional
from gymnasium_tpu_torch.envs.tabular.taxi import TaxiFunctional

__all__ = [
    "BlackJackTorchEnv",
    "BlackjackFunctional",
    "CliffWalkingFunctional",
    "CliffWalkingTorchEnv",
    "FrozenLake8x8Functional",
    "FrozenLakeFunctional",
    "TabularFuncEnv",
    "TaxiFunctional",
]
