"""Vector environments of the torch port: the device-resident
:class:`TorchVectorEnv` and the vector wrapper bases."""

from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv
from gymnasium_tpu_torch.vector.vector_env import (
    AutoresetMode,
    VectorActionWrapper,
    VectorEnv,
    VectorObservationWrapper,
    VectorRewardWrapper,
    VectorWrapper,
)

__all__ = [
    "VectorEnv",
    "VectorWrapper",
    "VectorObservationWrapper",
    "VectorActionWrapper",
    "VectorRewardWrapper",
    "AutoresetMode",
    "TorchVectorEnv",
    "utils",
]


def __getattr__(name):
    if name == "utils":
        import gymnasium_tpu_torch.vector.utils as utils

        return utils
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
