"""MultiBinary space: arrays of 0/1 values.

Host half copied from the JAX package's ``spaces/multi_binary.py`` (mask
values {0,1,2} where 2 means "sample randomly"; probability = P(element ==
1)); :meth:`MultiBinary.sample_torch` replaces ``sample_jax``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np
import torch

from gymnasium_tpu_torch.spaces.space import Space, sample_device


class MultiBinary(Space[np.ndarray]):
    """An n-shape binary space; elements are int8 arrays of 0s and 1s."""

    def __init__(
        self,
        n: np.ndarray | Sequence[int] | int,
        seed: int | np.random.Generator | None = None,
    ):
        if isinstance(n, (Sequence, np.ndarray)):
            self.n = input_n = tuple(int(i) for i in n)
            assert (np.asarray(input_n) > 0).all()
        else:
            self.n = int(n)
            input_n = (int(n),)
            assert self.n > 0
        super().__init__(input_n, np.int8, seed)

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape  # type: ignore[return-value]

    @property
    def is_np_flattenable(self) -> bool:
        return True

    def sample(self, mask: np.ndarray | None = None, probability: np.ndarray | None = None) -> np.ndarray:
        """Uniform 0/1 draws; with ``mask`` entries 0/1 force that value and 2
        samples randomly; with ``probability`` each entry is P(value == 1)."""
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )

        if mask is not None:
            assert isinstance(mask, np.ndarray), f"Expects mask to be np.ndarray, actual type: {type(mask)}"
            assert mask.dtype == np.int8, f"Expects mask dtype np.int8, actual dtype: {mask.dtype}"
            assert mask.shape == self.shape, f"Expects mask shape {self.shape}, actual shape: {mask.shape}"
            assert np.all((mask == 0) | (mask == 1) | (mask == 2)), (
                f"All values of the mask should be 0, 1, or 2, actual values: {mask}"
            )
            return np.where(
                mask == 2,
                self.np_random.integers(low=0, high=2, size=self.shape, dtype=self.dtype),
                mask,
            ).astype(self.dtype)

        if probability is not None:
            assert isinstance(probability, np.ndarray), (
                f"Expects probability to be np.ndarray, actual type: {type(probability)}"
            )
            assert probability.shape == self.shape, (
                f"Expects probability shape {self.shape}, actual shape: {probability.shape}"
            )
            assert np.all((probability >= 0) & (probability <= 1)), (
                f"All probabilities must be within [0, 1], actual values: {probability}"
            )
            return (self.np_random.random(self.shape) <= probability).astype(self.dtype)

        return self.np_random.integers(low=0, high=2, size=self.shape, dtype=self.dtype)

    def sample_torch(self, generator, batch_shape=(), device=None) -> torch.Tensor:
        """Fair 0/1 draws of shape ``batch_shape + shape``, int8."""
        return torch.randint(
            0,
            2,
            tuple(batch_shape) + self.shape,
            generator=generator,
            device=sample_device(generator, device),
            dtype=torch.int8,
        )

    def contains(self, x: Any) -> bool:
        if isinstance(x, (Sequence, np.ndarray)):
            x = np.asarray(x)
            return bool(self.shape == x.shape and np.all((x == 0) | (x == 1)))
        return False

    def contains_torch(self, x: torch.Tensor) -> torch.Tensor:
        return ((x == 0) | (x == 1)).all()

    def to_jsonable(self, sample_n: Sequence[np.ndarray]):
        return [np.asarray(sample).tolist() for sample in sample_n]

    def from_jsonable(self, sample_n: list[Sequence[int]]):
        return [np.asarray(sample, dtype=self.dtype) for sample in sample_n]

    def __repr__(self) -> str:
        return f"MultiBinary({self.n})"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, MultiBinary) and self.n == other.n
