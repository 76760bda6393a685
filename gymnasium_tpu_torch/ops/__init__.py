"""Hand-written CUDA kernels of the port, each beside its plain PyTorch twin.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor (see :mod:`gymnasium_tpu_torch.ops.build`).
"""

from gymnasium_tpu_torch.ops.cartpole_rollout import cartpole_rollout_fused

__all__ = ["cartpole_rollout_fused"]
