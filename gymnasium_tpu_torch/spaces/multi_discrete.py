"""MultiDiscrete space: a vector (or nd-grid) of Discrete ranges.

Host half copied from the JAX package's ``spaces/multi_discrete.py`` (nvec,
start, nested masks/probabilities, sub-space indexing);
:meth:`MultiDiscrete.sample_torch` replaces ``sample_jax``.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

import gymnasium_tpu_torch.logger as logger
from gymnasium_tpu_torch.spaces.space import Space, sample_device


class MultiDiscrete(Space[np.ndarray]):
    """Cartesian product of several Discrete spaces, one per element of ``nvec``."""

    def __init__(
        self,
        nvec: np.ndarray | list[int],
        dtype: Any = np.int64,
        seed: int | np.random.Generator | None = None,
        start: np.ndarray | list[int] | None = None,
    ):
        self.nvec = np.array(nvec, dtype=dtype, copy=True)
        if start is not None:
            self.start = np.array(start, dtype=dtype, copy=True)
        else:
            self.start = np.zeros(self.nvec.shape, dtype=dtype)
        assert self.start.shape == self.nvec.shape, "start and nvec (counts) should have the same shape"
        assert (self.nvec > 0).all(), "nvec (counts) have to be positive"
        super().__init__(self.nvec.shape, dtype, seed)

    @property
    def shape(self) -> tuple[int, ...]:
        return self._shape  # type: ignore[return-value]

    @property
    def is_np_flattenable(self) -> bool:
        return True

    def sample(
        self,
        mask: tuple | None = None,
        probability: tuple | None = None,
    ) -> np.ndarray:
        """Uniform sample; ``mask``/``probability`` are nested tuples mirroring
        the nvec structure, one per-component array each."""
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )

        if mask is not None:
            return self._masked_sample(mask, self.nvec, self.start, is_probability=False)
        if probability is not None:
            return self._masked_sample(probability, self.nvec, self.start, is_probability=True)

        return (self.np_random.random(self.nvec.shape) * self.nvec).astype(self.dtype) + self.start

    def _masked_sample(self, mask, nvec, start, is_probability: bool):
        if isinstance(mask, tuple):
            assert len(mask) == len(nvec), f"Expects mask length {len(nvec)}, actual {len(mask)}"
            return np.array(
                [
                    self._masked_sample(submask, subnvec, substart, is_probability)
                    for submask, subnvec, substart in zip(mask, nvec, start)
                ],
                dtype=self.dtype,
            )
        assert np.issubdtype(type(nvec), np.integer), (
            f"Expects the mask to be for an action, actual for {nvec}"
        )
        n = int(nvec)
        if is_probability:
            probability = np.asarray(mask, dtype=np.float64)
            assert probability.shape == (n,), f"Expects probability shape ({n},), actual {probability.shape}"
            assert np.isclose(probability.sum(), 1.0), f"Probabilities must sum to 1, got {probability.sum()}"
            return start + self.np_random.choice(n, p=probability)
        submask = np.asarray(mask)
        assert submask.dtype == np.int8, f"Expects mask dtype np.int8, actual {submask.dtype}"
        assert submask.shape == (n,), f"Expects mask shape ({n},), actual {submask.shape}"
        valid = np.where(submask)[0]
        if len(valid) == 0:
            return start
        return start + self.np_random.choice(valid)

    def sample_torch(self, generator, batch_shape=(), device=None) -> torch.Tensor:
        device = sample_device(generator, device)
        flat_n = torch.as_tensor(self.nvec.ravel(), dtype=torch.float32, device=device)
        u = torch.rand(
            tuple(batch_shape) + (flat_n.numel(),), generator=generator, device=device
        )
        sample = torch.floor(u * flat_n).to(torch.int32)
        start = torch.as_tensor(self.start, dtype=torch.int32, device=device)
        return sample.reshape(tuple(batch_shape) + self.nvec.shape) + start

    def contains(self, x: Any) -> bool:
        if isinstance(x, Sequence):
            x = np.array(x)
        return bool(
            isinstance(x, np.ndarray)
            and x.shape == self.shape
            and np.can_cast(x.dtype, self.dtype)
            and np.all(x >= self.start)
            and np.all(x - self.start < self.nvec)
        )

    def contains_torch(self, x: torch.Tensor) -> torch.Tensor:
        nvec = torch.as_tensor(self.nvec, device=x.device)
        start = torch.as_tensor(self.start, device=x.device)
        return (x >= start).all() & (x - start < nvec).all()

    def to_jsonable(self, sample_n: Iterable[np.ndarray]):
        return [sample.tolist() for sample in sample_n]

    def from_jsonable(self, sample_n: list[list[int]]):
        return [np.array(sample, dtype=self.dtype) for sample in sample_n]

    def __repr__(self) -> str:
        if np.any(self.start != 0):
            return f"MultiDiscrete({self.nvec}, start={self.start})"
        return f"MultiDiscrete({self.nvec})"

    def __getitem__(self, index: int | tuple[int, ...]):
        """Extract a subspace (Discrete or MultiDiscrete) at ``index``."""
        from gymnasium_tpu_torch.spaces.discrete import Discrete

        nvec = self.nvec[index]
        start = self.start[index]
        if nvec.ndim == 0:
            subspace = Discrete(int(nvec), start=int(start), dtype=self.dtype)
        else:
            subspace = MultiDiscrete(nvec, self.dtype, start=start)
        subspace.np_random.bit_generator.state = self.np_random.bit_generator.state
        return subspace

    def __len__(self) -> int:
        if self.nvec.ndim >= 2:
            logger.warn("Getting the length of a multi-dimensional MultiDiscrete space.")
        return len(self.nvec)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, MultiDiscrete)
            and self.dtype == other.dtype
            and self.shape == other.shape
            and np.all(self.nvec == other.nvec)
            and np.all(self.start == other.start)
        )

    def __setstate__(self, state: Iterable[tuple[str, Any]] | dict):
        super().__setstate__(state)
        if not hasattr(self, "start"):
            self.start = np.zeros(self.nvec.shape, dtype=self.dtype)
