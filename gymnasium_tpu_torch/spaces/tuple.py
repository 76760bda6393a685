"""Tuple space: a fixed-length product of subspaces.

Host half copied from the JAX package's ``spaces/tuple.py``;
:meth:`Tuple.sample_torch` replaces ``sample_jax`` and returns a tuple of
tensors when every subspace has a device sampler.
"""

from __future__ import annotations

import collections.abc
import typing
from typing import Any, Iterable

import numpy as np
import torch

from gymnasium_tpu_torch.spaces.space import Space


class Tuple(Space[typing.Tuple[Any, ...]], collections.abc.Sequence):
    """A tuple (product) of simpler spaces."""

    def __init__(
        self,
        spaces: Iterable[Space],
        seed: int | typing.Sequence[int] | np.random.Generator | None = None,
    ):
        self.spaces = tuple(spaces)
        for space in self.spaces:
            assert isinstance(space, Space), (
                f"{space} does not inherit from gymnasium_tpu_torch.Space. Actual Type: {type(space)}"
            )
        super().__init__(None, None, seed)  # type: ignore[arg-type]

    @property
    def is_np_flattenable(self) -> bool:
        return all(space.is_np_flattenable for space in self.spaces)

    def seed(self, seed: int | typing.Sequence[int] | None = None) -> tuple[Any, ...]:
        """Seed all subspaces; returns the per-subspace entropies used."""
        if seed is None:
            return tuple(space.seed(None) for space in self.spaces)
        if isinstance(seed, int):
            super().seed(seed)
            subseeds = self.np_random.integers(np.iinfo(np.int32).max, size=len(self.spaces))
            return tuple(
                space.seed(int(subseed)) for space, subseed in zip(self.spaces, subseeds)
            )
        if isinstance(seed, (list, tuple)):
            assert len(seed) == len(self.spaces), (
                f"Expects that the subspaces of seeds equals the number of subspaces. "
                f"Actual length of seeds: {len(seed)}, length of subspaces: {len(self.spaces)}"
            )
            return tuple(space.seed(s) for space, s in zip(self.spaces, seed))
        raise TypeError(f"Expected seed type: list, tuple, int or None, actual type: {type(seed)}")

    def sample(
        self,
        mask: tuple[Any | None, ...] | None = None,
        probability: tuple[Any | None, ...] | None = None,
    ) -> tuple[Any, ...]:
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )
        if mask is not None:
            assert isinstance(mask, tuple), (
                f"Expected type of `mask` to be tuple, actual type: {type(mask)}"
            )
            assert len(mask) == len(self.spaces), (
                f"Expected length of `mask` to be {len(self.spaces)}, actual length: {len(mask)}"
            )
            return tuple(space.sample(mask=m) for space, m in zip(self.spaces, mask))
        if probability is not None:
            assert isinstance(probability, tuple), (
                f"Expected type of `probability` to be tuple, actual type: {type(probability)}"
            )
            assert len(probability) == len(self.spaces), (
                f"Expected length of `probability` to be {len(self.spaces)}, actual length: {len(probability)}"
            )
            return tuple(space.sample(probability=p) for space, p in zip(self.spaces, probability))
        return tuple(space.sample() for space in self.spaces)

    def sample_torch(self, generator, batch_shape=(), device=None) -> tuple[Any, ...]:
        """The subspaces' batched samples, drawn in order from ``generator``
        (where JAX splits the key once a subspace)."""
        return tuple(space.sample_torch(generator, batch_shape, device) for space in self.spaces)

    def contains(self, x: Any) -> bool:
        if isinstance(x, (list, np.ndarray)):
            x = tuple(x)
        return (
            isinstance(x, tuple)
            and len(x) == len(self.spaces)
            and all(space.contains(part) for space, part in zip(self.spaces, x))
        )

    def contains_torch(self, x) -> torch.Tensor:
        checks = [space.contains_torch(part) for space, part in zip(self.spaces, x)]
        # a Discrete answers lane by lane; the tree answers once
        return torch.stack([check.all() for check in checks]).all()

    def __getitem__(self, index: int) -> Space:
        return self.spaces[index]

    def __len__(self) -> int:
        return len(self.spaces)

    def __repr__(self) -> str:
        return "Tuple(" + ", ".join(str(s) for s in self.spaces) + ")"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Tuple) and self.spaces == other.spaces

    def to_jsonable(self, sample_n: typing.Sequence[tuple[Any, ...]]) -> list[list[Any]]:
        return [
            space.to_jsonable([sample[i] for sample in sample_n])
            for i, space in enumerate(self.spaces)
        ]

    def from_jsonable(self, sample_n: list[list[Any]]) -> list[tuple[Any, ...]]:
        return [
            sample for sample in zip(
                *[space.from_jsonable(sample_n[i]) for i, space in enumerate(self.spaces)]
            )
        ]
