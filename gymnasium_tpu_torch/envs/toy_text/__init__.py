"""Toy-text MDPs as dense numpy models (the tabular functionals' tables)."""

from gymnasium_tpu_torch.envs.toy_text.cliffwalking import build_cliffwalking_model
from gymnasium_tpu_torch.envs.toy_text.frozen_lake import MAPS, build_frozen_lake_model
from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel, model_from_P
from gymnasium_tpu_torch.envs.toy_text.taxi import LOCS, MAP, build_taxi_model, decode, encode

__all__ = [
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
