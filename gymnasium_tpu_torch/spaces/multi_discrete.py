"""MultiDiscrete space: a vector of Discrete ranges.

The batched form of :class:`~gymnasium_tpu_torch.spaces.Discrete`, as
``batch_space`` builds it. Copied from the JAX package's
``spaces/multi_discrete.py`` without masked sampling or sub-space indexing,
which nothing in the port uses yet; :meth:`MultiDiscrete.sample_torch`
replaces ``sample_jax``.
"""

from __future__ import annotations

from typing import Any, Iterable, Sequence

import numpy as np
import torch

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

    def sample(self, mask: None = None, probability: None = None) -> np.ndarray:
        """Uniform sample."""
        if mask is not None or probability is not None:
            raise NotImplementedError("masked MultiDiscrete sampling is not ported")
        return (self.np_random.random(self.nvec.shape) * self.nvec).astype(self.dtype) + self.start

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

    def __len__(self) -> int:
        return len(self.nvec)

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, MultiDiscrete)
            and self.dtype == other.dtype
            and self.shape == other.shape
            and np.all(self.nvec == other.nvec)
            and np.all(self.start == other.start)
        )
