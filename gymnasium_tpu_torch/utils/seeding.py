"""Seeding: host-side PCG64 generators and device-side ``torch.Generator``s
(counterpart of the JAX package's ``utils/seeding.py``).

Bit-exact host sampling depends on identical PCG64 streams, so
:func:`np_random` keeps ``np.random.Generator(PCG64(SeedSequence(seed)))``
and returns the entropy used. :func:`torch_generator` takes the place of
``jax_key``: device-side randomness in the port comes from explicit
``torch.Generator``s.
"""

from __future__ import annotations

import numpy as np
import torch

from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.utils.device import resolve_device

__all__ = ["np_random", "torch_generator", "RandomNumberGenerator"]

RandomNumberGenerator = np.random.Generator


def np_random(seed: int | None = None) -> tuple[np.random.Generator, int]:
    """Return a PCG64 generator and the entropy used to seed it.

    Raises:
        gymnasium_tpu_torch.error.Error: if ``seed`` is negative or not an int.
    """
    if seed is not None and not (isinstance(seed, int) and 0 <= seed):
        if isinstance(seed, int):
            raise error.Error(f"Seed must be a non-negative integer, actual value: {seed}")
        raise error.Error(f"Seed must be a python integer, actual type: {type(seed)}")

    seed_seq = np.random.SeedSequence(seed)
    entropy = seed_seq.entropy
    assert isinstance(entropy, int)
    rng = np.random.Generator(np.random.PCG64(seed_seq))
    return rng, entropy


def torch_generator(seed: int | None = None, device: str | torch.device | None = None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded with ``seed`` (OS entropy
    mod 2**63 when ``None``).

    ``device`` resolves as the port's entry points do: ``None`` means CUDA,
    and without a card that raises unless the caller asks for the CPU.

    Raises:
        gymnasium_tpu_torch.error.Error: if ``seed`` is negative or not an int.
    """
    if seed is None:
        seed = int(np.random.SeedSequence().entropy) % (2**63)
    if not (isinstance(seed, int) and seed >= 0):
        raise error.Error(f"Seed must be a non-negative integer, actual value: {seed}")
    return torch.Generator(device=resolve_device(device)).manual_seed(seed)
