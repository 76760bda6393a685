"""Box space: (possibly unbounded) n-dimensional continuous/integer intervals.

Host half copied from the JAX package's ``spaces/box.py`` (per-element
low/high with dtype-aware bound casting, ``is_bounded``, and a ``sample`` that
mixes uniform / exponential / normal draws by boundedness).
:meth:`Box.sample_torch` replaces ``sample_jax`` with the same mixture.
"""

from __future__ import annotations

import warnings
from typing import Any, Iterable, Sequence, SupportsFloat

import numpy as np
import torch

from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.spaces.space import Space, sample_device


def _is_float_integer(value) -> bool:
    """Scalar integer or floating value (numpy or python)."""
    return np.issubdtype(type(value), np.integer) or np.issubdtype(
        type(value), np.floating
    )


class Box(Space[np.ndarray]):
    r"""A (possibly unbounded) box in :math:`\mathbb{R}^n`.

    Each coordinate is bounded by ``low[i] <= x[i] <= high[i]`` where either
    bound may be infinite.
    """

    def __init__(
        self,
        low: SupportsFloat | np.ndarray,
        high: SupportsFloat | np.ndarray,
        shape: Sequence[int] | None = None,
        dtype: Any = np.float32,
        seed: int | np.random.Generator | None = None,
    ):
        # The validation contract (error types AND messages) is the JAX
        # package's, which mirrors Gymnasium's (gymnasium/spaces/box.py:85-170).
        if dtype is None:
            raise ValueError("Box dtype must be explicitly provided, cannot be None.")
        self.dtype = np.dtype(dtype)
        if not (
            np.issubdtype(self.dtype, np.integer)
            or np.issubdtype(self.dtype, np.floating)
            or self.dtype == np.bool_
        ):
            raise ValueError(
                f"Invalid Box dtype ({self.dtype}), must be an integer, floating, or bool dtype"
            )

        # shape determination / inference
        if shape is not None:
            if not isinstance(shape, Iterable):
                raise TypeError(
                    f"Expected Box shape to be an iterable, actual type={type(shape)}"
                )
            if not all(np.issubdtype(type(dim), np.integer) for dim in shape):
                raise TypeError(
                    f"Expected all Box shape elements to be integer, actual type={tuple(type(dim) for dim in shape)}"
                )
            shape = tuple(int(dim) for dim in shape)
        elif isinstance(low, np.ndarray) and isinstance(high, np.ndarray):
            if low.shape != high.shape:
                raise ValueError(
                    f"Box low.shape and high.shape don't match, low.shape={low.shape}, high.shape={high.shape}"
                )
            shape = low.shape
        elif isinstance(low, np.ndarray):
            shape = low.shape
        elif isinstance(high, np.ndarray):
            shape = high.shape
        elif _is_float_integer(low) and _is_float_integer(high):
            shape = (1,)
        else:
            raise ValueError(
                "Box shape is not specified, therefore inferred from low and high. Expected low and high to be np.ndarray, integer, or float."
                f"Actual types low={type(low)}, high={type(high)}"
            )
        self._shape: tuple[int, ...] = shape

        if self.dtype == np.bool_:
            dtype_min, dtype_max = 0, 1
        elif np.issubdtype(self.dtype, np.floating):
            dtype_min = float(np.finfo(self.dtype).min)
            dtype_max = float(np.finfo(self.dtype).max)
        else:
            dtype_min = int(np.iinfo(self.dtype).min)
            dtype_max = int(np.iinfo(self.dtype).max)

        self.low, self.bounded_below = self._cast_bound(
            low, "low", dtype_min, dtype_max
        )
        self.high, self.bounded_above = self._cast_bound(
            high, "high", dtype_min, dtype_max
        )

        if self.low.shape != shape:
            raise ValueError(
                f"Box low.shape doesn't match provided shape, low.shape={self.low.shape}, shape={self._shape}"
            )
        if self.high.shape != shape:
            raise ValueError(
                f"Box high.shape doesn't match provided shape, high.shape={self.high.shape}, shape={self._shape}"
            )
        if np.any(self.low > self.high):
            raise ValueError(
                f"Box all low values must be less than or equal to high (some values break this), low={self.low}, high={self.high}"
            )

        self.low_repr = _short_repr(self.low)
        self.high_repr = _short_repr(self.high)

        super().__init__(shape, self.dtype, seed)

    def _cast_bound(self, value, name: str, dtype_min, dtype_max):
        """Validate and cast one bound; returns ``(array, boundedness mask)``.

        ``name`` is "low" or "high"; the messages match the reference's
        `_cast_low`/`_cast_high` exactly.
        """
        sign_inf = np.isneginf if name == "low" else np.isposinf
        inf_repr = "-np.inf" if name == "low" else "np.inf"
        limit = dtype_min if name == "low" else dtype_max

        if _is_float_integer(value):
            if name == "low":
                bounded = -np.inf < np.full(self._shape, value, dtype=float)
            else:
                bounded = np.full(self._shape, value, dtype=float) < np.inf

            if np.isnan(value):
                raise ValueError(f"No {name} value can be equal to `np.nan`, {name}={value}")
            elif sign_inf(value):
                if self.dtype.kind == "i":
                    value = limit
                elif self.dtype.kind in {"u", "b"}:
                    raise ValueError(
                        f"Box unsigned int dtype don't support `{inf_repr}`, {name}={value}"
                    )
            elif (name == "low" and value < dtype_min) or (
                name == "high" and value > dtype_max
            ):
                extremum = "min" if name == "low" else "max"
                raise ValueError(
                    f"Box {name} is out of bounds of the dtype range, {name}={value}, {extremum} dtype={limit}"
                )
            return np.full(self._shape, value, dtype=self.dtype), bounded

        if not isinstance(value, np.ndarray):
            raise ValueError(
                f"Box {name} must be a np.ndarray, integer, or float, actual type={type(value)}"
            )
        if not (
            np.issubdtype(value.dtype, np.floating)
            or np.issubdtype(value.dtype, np.integer)
            or value.dtype == np.bool_
        ):
            raise ValueError(
                f"Box {name} must be a floating, integer, or bool dtype, actual dtype={value.dtype}"
            )
        if np.any(np.isnan(value)):
            raise ValueError(f"No {name} value can be equal to `np.nan`, {name}={value}")

        bounded = (-np.inf < value) if name == "low" else (value < np.inf)

        inf_mask = sign_inf(value)
        if np.any(inf_mask):
            if self.dtype.kind == "i":
                # set the int limit AFTER the dtype cast: the reference writes
                # the limit into the float array first, where int64.max rounds
                # to 2^63 and overflows the later cast (reference box.py:292)
                out = np.where(inf_mask, 0, value).astype(self.dtype)
                out[inf_mask] = limit
                return out, bounded
            elif self.dtype.kind in {"u", "b"}:
                raise ValueError(
                    f"Box unsigned int dtype don't support `{inf_repr}`, {name}={value}"
                )
        elif value.dtype != self.dtype and (
            np.any(value < dtype_min) if name == "low" else np.any(value > dtype_max)
        ):
            extremum = "min" if name == "low" else "max"
            raise ValueError(
                f"Box {name} is out of bounds of the dtype range, {name}={value}, {extremum} dtype={limit}"
            )

        if (
            np.issubdtype(value.dtype, np.floating)
            and np.issubdtype(self.dtype, np.floating)
            and np.finfo(self.dtype).precision < np.finfo(value.dtype).precision
        ):
            warnings.warn(
                f"Box {name}'s precision lowered by casting to {self.dtype}, current {name}.dtype={value.dtype}"
            )
        return value.astype(self.dtype), bounded

    @property
    def shape(self) -> tuple[int, ...]:
        """Shape of box elements (always fixed)."""
        return self._shape  # type: ignore[return-value]

    @property
    def is_np_flattenable(self) -> bool:
        return True

    def is_bounded(self, manner: str = "both") -> bool:
        """Whether the box is bounded ``"below"``, ``"above"``, or ``"both"``."""
        below = bool(np.all(self.bounded_below))
        above = bool(np.all(self.bounded_above))
        if manner == "both":
            return below and above
        if manner == "below":
            return below
        if manner == "above":
            return above
        raise ValueError(
            f"manner is not in {{'below', 'above', 'both'}}, actual value: {manner}"
        )

    def sample(self, mask: None = None, probability: None = None) -> np.ndarray:
        """Sample mixing uniform/exponential/normal draws per-element boundedness."""
        if mask is not None:
            raise error.Error(
                f"Box.sample cannot be provided a mask, actual value: {mask}"
            )
        if probability is not None:
            raise error.Error(
                f"Box.sample cannot be provided a probability mask, actual value: {probability}"
            )

        high = self.high if self.dtype.kind == "f" else self.high.astype("int64") + 1
        sample = np.empty(self.shape)

        unbounded = ~self.bounded_below & ~self.bounded_above
        upp_bounded = ~self.bounded_below & self.bounded_above
        low_bounded = self.bounded_below & ~self.bounded_above
        bounded = self.bounded_below & self.bounded_above

        sample[unbounded] = self.np_random.normal(size=unbounded[unbounded].shape)
        sample[low_bounded] = (
            self.np_random.exponential(size=low_bounded[low_bounded].shape)
            + self.low[low_bounded]
        )
        sample[upp_bounded] = (
            -self.np_random.exponential(size=upp_bounded[upp_bounded].shape)
            + high[upp_bounded]
        )
        sample[bounded] = self.np_random.uniform(
            low=self.low[bounded], high=high[bounded], size=bounded[bounded].shape
        )

        if self.dtype.kind in "iub":
            sample = np.floor(sample)

        if self.dtype.kind in "iu":
            info = np.iinfo(self.dtype)
            sample = np.clip(sample, info.min, info.max)

        return sample.astype(self.dtype)

    def sample_torch(self, generator, batch_shape=(), device=None) -> torch.Tensor:
        """Batched sampler with the same per-element boundedness mixture.

        Draws float32 for floating boxes and int32 otherwise, as
        ``sample_jax`` does; ``batch_shape`` prepends leading axes.
        """
        device = sample_device(generator, device)
        shape = tuple(batch_shape) + self.shape
        f32 = dict(dtype=torch.float32, device=device)
        low = torch.as_tensor(np.where(self.bounded_below, self.low, 0.0), **f32)
        high = torch.as_tensor(np.where(self.bounded_above, self.high, 0.0), **f32)
        uniform = torch.rand(shape, generator=generator, **f32)
        normal = torch.randn(shape, generator=generator, **f32)
        exp1 = torch.empty(shape, **f32).exponential_(generator=generator)
        exp2 = torch.empty(shape, **f32).exponential_(generator=generator)

        below = torch.as_tensor(self.bounded_below, device=device)
        above = torch.as_tensor(self.bounded_above, device=device)
        bounded = low + uniform * (high - low)
        sample = torch.where(
            below & above,
            bounded,
            torch.where(below, low + exp1, torch.where(above, high - exp2, normal)),
        )
        if self.dtype.kind in "iu":
            sample = torch.floor(sample)
        return sample.to(torch.float32 if self.dtype.kind == "f" else torch.int32)

    def contains(self, x: Any) -> bool:
        if isinstance(x, torch.Tensor) and x.device.type != "cpu":
            # as for the same values on the host: cast to the space's dtype,
            # then one read of the device's answer
            if tuple(x.shape) != self.shape:
                return False
            cast = x.to(torch.from_numpy(np.empty((), self.dtype)).dtype)
            return bool(self.contains_torch(cast).item())
        if not isinstance(x, np.ndarray):
            try:
                x = np.asarray(x, dtype=self.dtype)
            except (ValueError, TypeError):
                return False
        return bool(
            np.can_cast(x.dtype, self.dtype)
            and x.shape == self.shape
            and np.all(x >= self.low)
            and np.all(x <= self.high)
        )

    def contains_torch(self, x: torch.Tensor) -> torch.Tensor:
        low = torch.as_tensor(self.low, device=x.device)
        high = torch.as_tensor(self.high, device=x.device)
        return (x >= low).all() & (x <= high).all()

    def to_jsonable(self, sample_n: Sequence[np.ndarray]) -> list[list]:
        return [np.asarray(s).tolist() for s in sample_n]

    def from_jsonable(self, sample_n: Sequence[list]) -> list[np.ndarray]:
        return [np.asarray(s, dtype=self.dtype) for s in sample_n]

    def __repr__(self) -> str:
        return f"Box({self.low_repr}, {self.high_repr}, {self.shape}, {self.dtype})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Box)
            and self.shape == other.shape
            and self.dtype == other.dtype
            and np.allclose(self.low, other.low)
            and np.allclose(self.high, other.high)
        )

    def __setstate__(self, state: Iterable[tuple[str, Any]] | dict):
        super().__setstate__(state)
        # Rebuild derived reprs for pickles from older versions.
        if not hasattr(self, "low_repr"):
            self.low_repr = _short_repr(self.low)
        if not hasattr(self, "high_repr"):
            self.high_repr = _short_repr(self.high)


def _short_repr(arr: np.ndarray) -> str:
    """``'-1.0'`` when the array is constant, else its full repr."""
    if arr.size != 0 and np.min(arr) == np.max(arr):
        return str(np.min(arr))
    return np.array2string(arr)
