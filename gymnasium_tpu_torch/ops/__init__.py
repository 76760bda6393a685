"""CUDA kernels of the port, each beside its plain PyTorch twin.

Importing this package builds nothing: a kernel is compiled with ``nvcc`` at
its first launch on a CUDA tensor (see :mod:`gymnasium_tpu_torch.ops.build`).
"""

from gymnasium_tpu_torch.ops.articulated_step import make_fused_step
from gymnasium_tpu_torch.ops.cartpole_rollout import cartpole_rollout_fused
from gymnasium_tpu_torch.ops.planar_step import make_fused_planar_step

__all__ = ["cartpole_rollout_fused", "make_fused_step", "make_fused_planar_step"]
