"""Vector-env utilities: space batching (copy of the JAX package's
``vector/utils``; the shared-memory and multiprocessing helpers of its host
vector envs are not ported)."""

from gymnasium_tpu_torch.vector.utils.space_utils import (
    batch_differing_spaces,
    batch_space,
    concatenate,
    create_empty_array,
    iterate,
)

__all__ = [
    "batch_space",
    "batch_differing_spaces",
    "iterate",
    "concatenate",
    "create_empty_array",
]
