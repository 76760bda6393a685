"""PyTorch/CUDA port of the gymnasium_tpu device path.

The package mirrors the JAX package's module layout (``functional``,
``envs.phys2d.cartpole``, ``vector``, ``ops``) so a reader can find each
counterpart, but it imports only ``torch`` and ``numpy``. Entry points run on
CUDA unless the caller passes ``device="cpu"``; without a card and without
that request they raise instead of falling back to the CPU.
"""

from gymnasium_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
