"""Text space: strings over a charset with bounded length.

Copy of the JAX package's ``spaces/text.py``, which follows Gymnasium's
(min/max length, charset, mask/probability sampling). Host-side only —
variable-length strings do not map onto fixed-shape device arrays (see
SURVEY.md §7 hard part 6).
"""

from __future__ import annotations

from typing import Any, FrozenSet

import numpy as np

from gymnasium_tpu_torch.spaces.space import Space

alphanumeric: frozenset[str] = frozenset(
    "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789"
)


class Text(Space[str]):
    """Strings of length in ``[min_length, max_length]`` over ``charset``."""

    def __init__(
        self,
        max_length: int,
        *,
        min_length: int = 1,
        charset: FrozenSet[str] | str = alphanumeric,
        seed: int | np.random.Generator | None = None,
    ):
        assert np.issubdtype(type(min_length), np.integer), (
            f"Expects the min_length to be an integer, actual type: {type(min_length)}"
        )
        assert np.issubdtype(type(max_length), np.integer), (
            f"Expects the max_length to be an integer, actual type: {type(max_length)}"
        )
        assert 0 <= min_length <= max_length, (
            f"Need 0 <= min_length <= max_length, got min={min_length} max={max_length}"
        )

        self.min_length: int = int(min_length)
        self.max_length: int = int(max_length)
        self._char_set: frozenset[str] = frozenset(charset)
        self._char_list: tuple[str, ...] = tuple(sorted(self._char_set))
        self._char_index: dict[str, np.int32] = {
            val: np.int32(i) for i, val in enumerate(self._char_list)
        }
        self._char_str: str = "".join(self._char_list)

        super().__init__(dtype=str, seed=seed)

    @property
    def character_set(self) -> frozenset[str]:
        """The allowed character set."""
        return self._char_set

    @property
    def character_list(self) -> tuple[str, ...]:
        """The allowed characters, sorted."""
        return self._char_list

    def character_index(self, char: str) -> np.int32:
        """Index of ``char`` within the sorted character list."""
        return self._char_index[char]

    @property
    def characters(self) -> str:
        """The allowed characters as a single sorted string."""
        return self._char_str

    @property
    def is_np_flattenable(self) -> bool:
        """Flattens to an int32 char-index array padded to max_length
        (reference text.py:222)."""
        return True

    def sample(
        self,
        mask: tuple[int | None, np.ndarray | None] | None = None,
        probability: tuple[int | None, np.ndarray | None] | None = None,
    ) -> str:
        """Sample a string; ``mask``/``probability`` is ``(length, charmask)``."""
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )

        length = None
        charlist_mask: np.ndarray | None = None
        is_probability = probability is not None
        chosen = probability if is_probability else mask
        if chosen is not None:
            assert isinstance(chosen, tuple) and len(chosen) == 2, (
                f"Expects a tuple (length, mask), actual value: {chosen}"
            )
            length, charlist_mask = chosen
            if length is not None:
                assert np.issubdtype(type(length), np.integer)
                assert self.min_length <= length <= self.max_length, (
                    f"Length {length} outside [{self.min_length}, {self.max_length}]"
                )
            if charlist_mask is not None:
                assert isinstance(charlist_mask, np.ndarray)
                assert charlist_mask.shape == (len(self._char_list),), (
                    f"Expects mask shape ({len(self._char_list)},), actual {charlist_mask.shape}"
                )
                if is_probability:
                    assert np.all(np.logical_and(charlist_mask >= 0, charlist_mask <= 1)), (
                        f"Expects all values in the probability mask to be between 0 and 1, actual values: {charlist_mask}"
                    )
                    assert np.isclose(np.sum(charlist_mask), 1.0), (
                        f"Expects the sum of the probability mask to be 1, actual sum: {np.sum(charlist_mask)}"
                    )
                else:
                    assert charlist_mask.dtype == np.int8
                    assert np.all((charlist_mask == 0) | (charlist_mask == 1))

        if length is None:
            length = int(self.np_random.integers(self.min_length, self.max_length + 1))

        if charlist_mask is None:
            indices = self.np_random.integers(0, len(self._char_list), size=length)
        elif is_probability:
            indices = self.np_random.choice(len(self._char_list), size=length, p=charlist_mask)
        else:
            valid = np.where(charlist_mask)[0]
            if len(valid) == 0:
                if self.min_length == 0:
                    return ""
                raise ValueError(
                    f"Trying to sample with a minimum length > 0 (actual minimum length={self.min_length}) but the character mask is all zero meaning that no character could be sampled."
                )
            indices = self.np_random.choice(valid, size=length)

        return "".join(self._char_list[i] for i in indices)

    def contains(self, x: Any) -> bool:
        if isinstance(x, str) and self.min_length <= len(x) <= self.max_length:
            return all(c in self._char_set for c in x)
        return False

    def __repr__(self) -> str:
        return f"Text({self.min_length}, {self.max_length}, characters={self.characters})"

    def __eq__(self, other: Any) -> bool:
        return (
            isinstance(other, Text)
            and self.min_length == other.min_length
            and self.max_length == other.max_length
            and self._char_set == other._char_set
        )
