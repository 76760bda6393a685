"""Host-side PCG64 seeding (copy of the JAX package's ``utils/seeding.np_random``).

Bit-exact host sampling depends on identical PCG64 streams, so this keeps
``np.random.Generator(PCG64(SeedSequence(seed)))`` and returns the entropy used.
Device-side randomness in the port comes from explicit ``torch.Generator``s.
"""

from __future__ import annotations

import numpy as np

from gymnasium_tpu_torch import error

__all__ = ["np_random"]


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
