"""Fixed-shape spaces of the torch port, with host and device sampling."""

from gymnasium_tpu_torch.spaces.box import Box
from gymnasium_tpu_torch.spaces.discrete import Discrete
from gymnasium_tpu_torch.spaces.multi_discrete import MultiDiscrete
from gymnasium_tpu_torch.spaces.space import Space

__all__ = ["Space", "Box", "Discrete", "MultiDiscrete"]
