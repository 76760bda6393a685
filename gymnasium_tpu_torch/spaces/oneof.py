"""OneOf space: a tagged (exclusive) union of subspaces.

Copy of the JAX package's ``spaces/oneof.py``, which follows Gymnasium's —
samples are ``(index, subsample)`` pairs.
"""

from __future__ import annotations

import typing
from typing import Any, Iterable

import numpy as np

from gymnasium_tpu_torch.spaces.space import Space


class OneOf(Space[Any]):
    """An exclusive union of subspaces; samples are ``(space_index, sample)``."""

    def __init__(
        self,
        spaces: Iterable[Space[Any]],
        seed: int | typing.Sequence[int] | np.random.Generator | None = None,
    ):
        self.spaces = tuple(spaces)
        assert len(self.spaces) > 0, "Empty `OneOf` spaces are not supported."
        for space in self.spaces:
            assert isinstance(space, Space), (
                f"{space} does not inherit from `gymnasium_tpu_torch.Space`. Actual Type: {type(space)}"
            )
        super().__init__(None, None, seed)  # type: ignore[arg-type]

    @property
    def is_np_flattenable(self) -> bool:
        return all(space.is_np_flattenable for space in self.spaces)

    def seed(self, seed: int | typing.Sequence[int] | None = None) -> tuple[int, ...]:
        """Seed the selector PRNG and all subspaces."""
        if seed is None:
            return (super().seed(None), *(space.seed(None) for space in self.spaces))
        if isinstance(seed, int):
            super_seed = super().seed(seed)
            subseeds = self.np_random.integers(np.iinfo(np.int32).max, size=len(self.spaces))
            # re-seed so int- and tuple-seeding leave the PRNG in the same
            # state (reference oneof.py:84-85)
            super().seed(seed)
            return (super_seed, *(space.seed(int(s)) for space, s in zip(self.spaces, subseeds)))
        if isinstance(seed, (list, tuple)):
            assert len(seed) == len(self.spaces) + 1, (
                f"Expects a seed of length {len(self.spaces) + 1}, actual length: {len(seed)}"
            )
            return (
                super().seed(seed[0]),
                *(space.seed(s) for space, s in zip(self.spaces, seed[1:])),
            )
        raise TypeError(f"Expected None, int, or tuple of ints, actual type: {type(seed)}")

    def sample(
        self,
        mask: tuple[Any | None, ...] | None = None,
        probability: tuple[Any | None, ...] | None = None,
    ) -> tuple[np.int64, Any]:
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )
        idx = self.np_random.integers(0, len(self.spaces))
        subspace = self.spaces[idx]
        if mask is not None:
            assert isinstance(mask, tuple), (
                f"Expected type of `mask` is tuple, actual type: {type(mask)}"
            )
            assert len(mask) == len(self.spaces), (
                f"Expected length of `mask` is {len(self.spaces)}, actual length: {len(mask)}"
            )
            sample = subspace.sample(mask=mask[idx])
        elif probability is not None:
            assert isinstance(probability, tuple), (
                f"Expected type of `probability` is tuple, actual type: {type(probability)}"
            )
            assert len(probability) == len(self.spaces), (
                f"Expected length of `probability` is {len(self.spaces)}, actual length: {len(probability)}"
            )
            sample = subspace.sample(probability=probability[idx])
        else:
            sample = subspace.sample()
        return np.int64(idx), sample

    def contains(self, x: Any) -> bool:
        # index must be a python int or np.int64 (reference oneof.py:154-163)
        return (
            isinstance(x, tuple)
            and len(x) == 2
            and isinstance(x[0], (np.int64, int))
            and 0 <= x[0] < len(self.spaces)
            and self.spaces[x[0]].contains(x[1])
        )

    def __getitem__(self, index: int) -> Space[Any]:
        return self.spaces[index]

    def __len__(self) -> int:
        return len(self.spaces)

    def __repr__(self) -> str:
        return "OneOf(" + ", ".join(str(space) for space in self.spaces) + ")"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, OneOf) and self.spaces == other.spaces

    def to_jsonable(self, sample_n: typing.Sequence[tuple[np.int64, Any]]) -> list[list[Any]]:
        return [
            [int(idx), self.spaces[int(idx)].to_jsonable([sub])[0]] for idx, sub in sample_n
        ]

    def from_jsonable(self, sample_n: list[list[Any]]) -> list[tuple[np.int64, Any]]:
        return [
            (np.int64(idx), self.spaces[int(idx)].from_jsonable([sub])[0])
            for idx, sub in sample_n
        ]
