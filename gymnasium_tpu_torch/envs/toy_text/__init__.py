"""Toy-text host env classes behind ``make(id)`` (counterpart of the JAX
package's ``envs/toy_text``; reference gymnasium/envs/toy_text/__init__.py),
and their dense numpy models, which the tabular functionals step on the card."""

from gymnasium_tpu_torch.envs.toy_text.blackjack import BlackjackEnv
from gymnasium_tpu_torch.envs.toy_text.cliffwalking import CliffWalkingEnv, build_cliffwalking_model
from gymnasium_tpu_torch.envs.toy_text.frozen_lake import MAPS, FrozenLakeEnv, build_frozen_lake_model
from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel, model_from_P
from gymnasium_tpu_torch.envs.toy_text.taxi import LOCS, MAP, TaxiEnv, build_taxi_model, decode, encode

__all__ = [
    "BlackjackEnv",
    "CliffWalkingEnv",
    "FrozenLakeEnv",
    "TaxiEnv",
    "LOCS",
    "MAP",
    "MAPS",
    "TabularModel",
    "build_cliffwalking_model",
    "build_frozen_lake_model",
    "build_taxi_model",
    "decode",
    "encode",
    "model_from_P",
]
