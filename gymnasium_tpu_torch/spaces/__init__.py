"""Spaces of the torch port: host sampling as the JAX package's, and device
sampling (``sample_torch``/``contains_torch``) for the fixed-shape ones."""

from gymnasium_tpu_torch.spaces.box import Box
from gymnasium_tpu_torch.spaces.dict import Dict
from gymnasium_tpu_torch.spaces.discrete import Discrete
from gymnasium_tpu_torch.spaces.graph import Graph, GraphInstance
from gymnasium_tpu_torch.spaces.multi_binary import MultiBinary
from gymnasium_tpu_torch.spaces.multi_discrete import MultiDiscrete
from gymnasium_tpu_torch.spaces.oneof import OneOf
from gymnasium_tpu_torch.spaces.sequence import Sequence
from gymnasium_tpu_torch.spaces.space import Space
from gymnasium_tpu_torch.spaces.text import Text
from gymnasium_tpu_torch.spaces.tuple import Tuple
from gymnasium_tpu_torch.spaces.utils import (
    flatdim,
    flatten,
    flatten_space,
    is_space_dtype_shape_equiv,
    unflatten,
)

__all__ = [
    "Space",
    "Box",
    "Discrete",
    "MultiDiscrete",
    "MultiBinary",
    "Text",
    "Dict",
    "Tuple",
    "Sequence",
    "Graph",
    "GraphInstance",
    "OneOf",
    "flatdim",
    "flatten",
    "flatten_space",
    "unflatten",
    "is_space_dtype_shape_equiv",
]
