"""Experimental module (copy of the JAX package's ``experimental/``, which
follows Gymnasium's gymnasium/experimental/__init__.py).

The functional API is first-class and lives at
``gymnasium_tpu_torch.functional``; this package re-exports it under
Gymnasium's ``experimental`` path.
"""

from gymnasium_tpu_torch.experimental import functional

__all__ = ["functional"]
