"""Vector environments of the torch port."""

from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv

__all__ = ["AutoresetMode", "TorchVectorEnv", "VectorEnv"]
