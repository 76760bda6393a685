"""Vector environments of the torch port: the device-resident
:class:`TorchVectorEnv`, the host-side :class:`SyncVectorEnv` and
:class:`AsyncVectorEnv` for wrapping arbitrary Python envs, and the vector
wrapper bases."""

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
    "SyncVectorEnv",
    "AsyncVectorEnv",
    "utils",
]


def __getattr__(name):
    # the host implementations import lazily (multiprocessing)
    if name == "SyncVectorEnv":
        from gymnasium_tpu_torch.vector.sync_vector_env import SyncVectorEnv

        return SyncVectorEnv
    if name == "AsyncVectorEnv":
        from gymnasium_tpu_torch.vector.async_vector_env import AsyncVectorEnv

        return AsyncVectorEnv
    if name == "utils":
        import gymnasium_tpu_torch.vector.utils as utils

        return utils
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
