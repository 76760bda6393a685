"""Vector-env utilities: space batching, shared memory, misc helpers (copy of
the JAX package's ``vector/utils``)."""

from gymnasium_tpu_torch.vector.utils.space_utils import (
    batch_differing_spaces,
    batch_space,
    concatenate,
    create_empty_array,
    iterate,
)

# Lazy names and their home submodules: shared-memory and misc helpers drag
# in multiprocessing, which the pure-device path never needs.
_LAZY = {
    "create_shared_memory": "shared_memory",
    "read_from_shared_memory": "shared_memory",
    "write_to_shared_memory": "shared_memory",
    "CloudpickleWrapper": "misc",
    "clear_mpi_env_vars": "misc",
}

__all__ = [
    "batch_space",
    "batch_differing_spaces",
    "iterate",
    "concatenate",
    "create_empty_array",
    *_LAZY,
]


def __getattr__(name):
    submodule = _LAZY.get(name)
    if submodule is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(f"{__name__}.{submodule}"), name)
