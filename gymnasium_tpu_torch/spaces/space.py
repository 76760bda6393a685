"""Space base class (host half copied from the JAX package's ``spaces/space.py``).

The JAX package's device hooks ``sample_jax``/``contains_jax`` become
:meth:`Space.sample_torch` and :meth:`Space.contains_torch`: batched sampling
from an explicit ``torch.Generator`` and a tensor membership predicate, both
on the device of their inputs, so a batch of actions never leaves the card.
"""

from __future__ import annotations

from typing import Any, Generic, Iterable, Mapping, Sequence, TypeVar

import numpy as np
import torch

from gymnasium_tpu_torch.utils import seeding

T_cov = TypeVar("T_cov", covariant=True)


class Space(Generic[T_cov]):
    """Superclass defining an observation/action domain."""

    def __init__(
        self,
        shape: Sequence[int] | None = None,
        dtype: Any | None = None,
        seed: int | np.random.Generator | None = None,
    ):
        self._shape = None if shape is None else tuple(shape)
        self.dtype = None if dtype is None else np.dtype(dtype)
        self._np_random: np.random.Generator | None = None
        if seed is not None:
            if isinstance(seed, np.random.Generator):
                self._np_random = seed
            else:
                self.seed(seed)

    # -- numpy RNG ---------------------------------------------------------

    @property
    def np_random(self) -> np.random.Generator:
        """Lazily-initialised PCG64 generator used by :meth:`sample`."""
        if self._np_random is None:
            self.seed()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random = value

    def seed(self, seed: int | None = None) -> int:
        """Seed the space's PRNG, returning the entropy actually used."""
        self._np_random, np_random_seed = seeding.np_random(seed)
        return np_random_seed

    # -- shape/dtype -------------------------------------------------------

    @property
    def shape(self) -> tuple[int, ...] | None:
        """Shape of elements of the space, or ``None`` if not fixed-shape."""
        return self._shape

    @property
    def is_np_flattenable(self) -> bool:
        """Whether the space can be flattened to a fixed-size numpy array."""
        raise NotImplementedError

    # -- sampling/membership ----------------------------------------------

    def sample(self, mask: Any | None = None, probability: Any | None = None) -> T_cov:
        """Randomly sample an element, optionally restricted by a mask."""
        raise NotImplementedError

    def contains(self, x: Any) -> bool:
        """Return whether ``x`` is a valid member of the space."""
        raise NotImplementedError

    def __contains__(self, x: Any) -> bool:
        return self.contains(x)

    # -- device path -------------------------------------------------------

    def sample_torch(
        self,
        generator: torch.Generator,
        batch_shape: tuple[int, ...] = (),
        device: torch.device | str | None = None,
    ) -> torch.Tensor:
        """Batched sample of shape ``batch_shape + shape`` drawn from ``generator``.

        ``device`` defaults to the generator's device. Fixed-shape subclasses
        override; others raise.
        """
        raise NotImplementedError(
            f"{type(self).__name__} has no device-resident sampler; "
            "use the host-side sample() instead."
        )

    def contains_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Membership predicate on a tensor, returning a bool tensor."""
        raise NotImplementedError(
            f"{type(self).__name__} has no device-resident contains; "
            "use the host-side contains() instead."
        )

    # -- (de)serialization -------------------------------------------------

    def to_jsonable(self, sample_n: Sequence[T_cov]) -> list[Any]:
        """Convert a batch of samples to a JSON-able list."""
        return list(sample_n)

    def from_jsonable(self, sample_n: list[Any]) -> list[T_cov]:
        """Convert a JSON-able list back to a batch of samples."""
        return sample_n

    # -- pickling ----------------------------------------------------------

    def __setstate__(self, state: Iterable[tuple[str, Any]] | Mapping[str, Any]):
        state = dict(state)
        if "np_random" in state:
            state["_np_random"] = state.pop("np_random")
        if "shape" in state:
            state["_shape"] = state.pop("shape")
        self.__dict__.update(state)


def numpy_dtype(dtype) -> np.dtype:
    """The numpy counterpart of a torch or numpy dtype (bfloat16 has none and
    maps to float32, the type it widens to losslessly)."""
    if isinstance(dtype, torch.dtype):
        if dtype == torch.bfloat16:
            return np.dtype(np.float32)
        return torch.empty((), dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def sample_device(generator: torch.Generator, device) -> torch.device:
    """The device a sampler draws on: ``device``, else the generator's."""
    return generator.device if device is None else torch.device(device)
