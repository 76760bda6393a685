"""Sequence space: variable-length sequences of a fixed subspace.

Copy of the JAX package's ``spaces/sequence.py``, which follows Gymnasium's
(tuple or stacked representation, ``mask=(length_mask, feature_mask)``).
Host-side only — see SURVEY.md §7 hard part 6 on variable-shape spaces.
"""

from __future__ import annotations

import typing
from typing import Any, Union

import numpy as np

from gymnasium_tpu_torch.spaces.space import Space


class Sequence(Space[Union[typing.Tuple[Any, ...], Any]]):
    """Variable-length sequences over ``space``; ``stack=True`` stacks samples."""

    def __init__(
        self,
        space: Space[Any],
        seed: int | np.random.Generator | None = None,
        stack: bool = False,
    ):
        assert isinstance(space, Space), (
            f"Expects the feature space to be instance of a gymnasium_tpu_torch Space, actual type: {type(space)}"
        )
        self.feature_space = space
        self.stack = stack
        if self.stack:
            from gymnasium_tpu_torch.vector.utils import batch_space

            self.stacked_feature_space: Space = batch_space(self.feature_space, 1)
        super().__init__(None, None, seed)  # type: ignore[arg-type]

    def seed(self, seed: int | tuple[int, int] | None = None) -> tuple[int, Any]:
        """Seed the length-PRNG and the feature space."""
        if seed is None:
            return super().seed(None), self.feature_space.seed(None)
        if isinstance(seed, int):
            super_seed = super().seed(seed)
            feature_seed = int(self.np_random.integers(np.iinfo(np.int32).max))
            # re-seed so int- and tuple-seeding leave the PRNG in the same
            # state (reference sequence.py:83-84)
            super().seed(seed)
            return super_seed, self.feature_space.seed(feature_seed)
        if isinstance(seed, tuple):
            assert len(seed) == 2
            return super().seed(seed[0]), self.feature_space.seed(seed[1])
        raise TypeError(f"Expected None, int, tuple of ints, actual type: {type(seed)}")

    @property
    def is_np_flattenable(self) -> bool:
        return False

    def _sample_length(self, length_mask, mask_type=None) -> int:
        if length_mask is not None:
            if np.issubdtype(type(length_mask), np.integer):
                assert 0 <= length_mask, (
                    f"Expects the length mask of `{mask_type}` to be greater than or equal to zero, actual value: {length_mask}"
                )
                return int(length_mask)
            if isinstance(length_mask, np.ndarray):
                assert len(length_mask.shape) == 1, (
                    f"Expects the shape of the length mask of `{mask_type}` to be 1-dimensional, actual shape: {length_mask.shape}"
                )
                assert np.all(0 <= length_mask), (
                    f"Expects all values in the length_mask of `{mask_type}` to be greater than or equal to zero, actual values: {length_mask}"
                )
                assert np.issubdtype(length_mask.dtype, np.integer), (
                    f"Expects the length mask array of `{mask_type}` to have dtype of np.integer, actual type: {length_mask.dtype}"
                )
                return int(self.np_random.choice(length_mask))
            raise TypeError(
                f"Expects the type of length_mask of `{mask_type}` to be an integer or a np.ndarray, actual type: {type(length_mask)}"
            )
        # Geometric-ish default so sampled lengths stay small but unbounded.
        return int(self.np_random.geometric(0.25))

    def sample(
        self,
        mask: None | tuple[Any, Any] = None,
        probability: None | tuple[Any, Any] = None,
    ) -> tuple[Any, ...] | Any:
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )
        length_mask, feature_mask = (None, None)
        use_probability = probability is not None
        chosen = probability if use_probability else mask
        if chosen is not None:
            assert isinstance(chosen, tuple) and len(chosen) == 2, (
                f"Expects the mask to be a tuple of length 2, actual value: {chosen}"
            )
            length_mask, feature_mask = chosen

        length = self._sample_length(length_mask, "probability" if use_probability else "mask")
        if use_probability:
            sampled = tuple(
                self.feature_space.sample(probability=feature_mask) for _ in range(length)
            )
        else:
            sampled = tuple(self.feature_space.sample(mask=feature_mask) for _ in range(length))

        if self.stack:
            from gymnasium_tpu_torch.vector.utils import batch_space, concatenate, create_empty_array

            out = create_empty_array(self.feature_space, len(sampled))
            return concatenate(self.feature_space, sampled, out)
        return sampled

    def contains(self, x: Any) -> bool:
        if self.stack:
            from gymnasium_tpu_torch.vector.utils import iterate

            try:
                return all(self.feature_space.contains(item) for item in iterate(self.stacked_feature_space, x))
            except Exception:
                return False
        return isinstance(x, tuple) and all(self.feature_space.contains(item) for item in x)

    def __repr__(self) -> str:
        return f"Sequence({self.feature_space}, stack={self.stack})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Sequence)
            and self.feature_space == other.feature_space
            and self.stack == other.stack
        )

    def to_jsonable(self, sample_n) -> list[list[Any]]:
        if self.stack:
            from gymnasium_tpu_torch.vector.utils import iterate

            sample_n = [tuple(iterate(self.stacked_feature_space, sample)) for sample in sample_n]
        return [self.feature_space.to_jsonable(list(sample)) for sample in sample_n]

    def from_jsonable(self, sample_n: list[list[Any]]):
        samples = [tuple(self.feature_space.from_jsonable(sample)) for sample in sample_n]
        if self.stack:
            from gymnasium_tpu_torch.vector.utils import concatenate, create_empty_array

            return [
                concatenate(
                    self.feature_space, sample, create_empty_array(self.feature_space, len(sample))
                )
                for sample in samples
            ]
        return samples
