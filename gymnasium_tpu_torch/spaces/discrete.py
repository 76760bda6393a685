"""Discrete space: integers in ``[start, start + n)``.

Host half copied from the JAX package's ``spaces/discrete.py``;
:meth:`Discrete.sample_torch` replaces ``sample_jax`` and, like it, draws int32.
"""

from __future__ import annotations

from typing import Any, Iterable

import numpy as np
import torch

from gymnasium_tpu_torch.spaces.space import Space, sample_device


class Discrete(Space[np.int64]):
    r"""Finite set :math:`\{start, start+1, \dots, start+n-1\}`."""

    def __init__(
        self,
        n: int | np.integer,
        seed: int | np.random.Generator | None = None,
        start: int | np.integer = 0,
        dtype: str | type[np.integer] = np.int64,
    ):
        assert np.issubdtype(type(n), np.integer), f"Expects `n` to be an int, actual type: {type(n)}"
        assert n > 0, "n (counts of elements) have to be positive"
        assert np.issubdtype(type(start), np.integer), f"Expects `start` to be an int, actual type: {type(start)}"
        if dtype is None:
            raise TypeError(f"Invalid Discrete dtype, cannot be {dtype}.")
        self.dtype = np.dtype(dtype)
        if not np.issubdtype(self.dtype, np.integer):
            raise TypeError(
                f"Invalid Discrete dtype ({self.dtype}), must be an integer dtype"
            )
        self.n = self.dtype.type(n)
        self.start = self.dtype.type(start)
        super().__init__((), self.dtype, seed)

    @property
    def is_np_flattenable(self) -> bool:
        return True

    def sample(self, mask: np.ndarray | None = None, probability: np.ndarray | None = None) -> np.int64:
        """Uniform sample; with ``mask`` (int8 0/1) restrict support; with
        ``probability`` (float, sums to 1) sample from that distribution."""
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )

        if mask is not None:
            assert isinstance(mask, np.ndarray), (
                f"The expected type of the sample mask is np.ndarray, actual type: {type(mask)}"
            )
            assert mask.dtype == np.int8, (
                f"The expected dtype of the sample mask is np.int8, actual dtype: {mask.dtype}"
            )
            assert mask.shape == (self.n,), (
                f"The expected shape of the sample mask is {(int(self.n),)}, actual shape: {mask.shape}"
            )
            valid_action_mask = mask == 1
            assert np.all(np.logical_or(mask == 0, valid_action_mask)), (
                f"All values of the sample mask should be 0 or 1, actual values: {mask}"
            )
            if np.any(valid_action_mask):
                return self.start + self.dtype.type(
                    self.np_random.choice(np.where(valid_action_mask)[0])
                )
            return self.start

        if probability is not None:
            assert isinstance(probability, np.ndarray), (
                f"The expected type of the sample probability is np.ndarray, actual type: {type(probability)}"
            )
            assert probability.dtype == np.float64, (
                f"The expected dtype of the sample probability is np.float64, actual dtype: {probability.dtype}"
            )
            assert probability.shape == (self.n,), (
                f"The expected shape of the sample probability is {(int(self.n),)}, actual shape: {probability.shape}"
            )
            assert np.all(np.logical_and(probability >= 0, probability <= 1)), (
                f"All values of the sample probability should be between 0 and 1, actual values: {probability}"
            )
            assert np.isclose(np.sum(probability), 1), (
                f"The sum of the sample probability should be equal to 1, actual sum: {np.sum(probability)}"
            )
            return self.start + self.np_random.choice(
                np.arange(self.n, dtype=self.dtype), p=probability
            )

        return self.start + self.np_random.integers(self.n, dtype=self.dtype.type)

    def sample_torch(self, generator, batch_shape=(), device=None) -> torch.Tensor:
        draw = torch.randint(
            0,
            int(self.n),
            tuple(batch_shape),
            generator=generator,
            device=sample_device(generator, device),
            dtype=torch.int32,
        )
        return draw + int(self.start)

    def contains(self, x: Any) -> bool:
        """Membership, including the dtype-castability rule: an integer
        scalar is a member only if its value is in range AND its dtype safely
        casts to the space's."""
        if isinstance(x, int):
            as_np = self.dtype.type(x)
        elif (
            hasattr(x, "dtype")
            and np.issubdtype(x.dtype, np.integer)
            and getattr(x, "shape", None) == ()
        ):
            as_np = x
        else:
            return False
        value_is_in = bool(self.start <= as_np < self.start + self.n)
        return value_is_in and np.can_cast(as_np.dtype, self.dtype)

    def contains_torch(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise membership of a batch of integers."""
        return (x >= int(self.start)) & (x < int(self.start + self.n))

    def __repr__(self) -> str:
        info = [str(self.n)]
        if self.start != 0:
            info.append(f"start={self.start}")
        if self.dtype != np.int64:
            info.append(f"dtype={self.dtype}")
        return f"Discrete({', '.join(info)})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Discrete)
            and self.n == other.n
            and self.start == other.start
            and self.dtype == other.dtype
        )

    def __setstate__(self, state: Iterable[tuple[str, Any]] | dict):
        super().__setstate__(state)
        if not hasattr(self, "start"):
            self.start = np.int64(0)

    def to_jsonable(self, sample_n):
        return [int(x) for x in sample_n]

    def from_jsonable(self, sample_n):
        return [self.dtype.type(x) for x in sample_n]
