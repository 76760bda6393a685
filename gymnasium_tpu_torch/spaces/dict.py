"""Dict space: an ordered mapping of named subspaces.

Host half copied from the JAX package's ``spaces/dict.py`` (keys sorted at
construction when built from a plain dict, seed by dict/int, sample by mask
dict). :meth:`Dict.sample_torch` replaces ``sample_jax``: it draws the
subspaces in order from one generator and returns a dict of tensors.
"""

from __future__ import annotations

import collections.abc
import typing
from typing import Any, Sequence

import numpy as np
import torch

from gymnasium_tpu_torch.spaces.space import Space


class Dict(Space[typing.Dict[str, Any]], collections.abc.Mapping):
    """A dictionary of simpler spaces; elements are dicts of subspace elements."""

    def __init__(
        self,
        spaces: dict[str, Space] | Sequence[tuple[str, Space]] | None = None,
        seed: dict | int | np.random.Generator | None = None,
        **spaces_kwargs: Space,
    ):
        if spaces is None:
            spaces = dict(spaces_kwargs)
            spaces_kwargs = {}
        elif isinstance(spaces, collections.OrderedDict):
            # An explicit OrderedDict preserves insertion order (reference dict.py:71).
            spaces = dict(spaces.items())
        elif isinstance(spaces, collections.abc.Mapping):
            # Sort non-OrderedDict keys for reproducible flatten order.
            try:
                spaces = dict(sorted(spaces.items()))
            except TypeError:
                spaces = dict(spaces.items())
        elif isinstance(spaces, Sequence):
            spaces = dict(spaces)

        if not isinstance(spaces, dict):
            raise TypeError(
                f"Unexpected Dict space input, expecting dict, OrderedDict or Sequence, actual type: {type(spaces)}"
            )

        # kwargs merge with a provided mapping (reference dict.py:91-95)
        for key, space in spaces_kwargs.items():
            if key not in spaces:
                spaces[key] = space
            else:
                raise ValueError(
                    f"Dict space keyword '{key}' already exists in the spaces dictionary"
                )
        for key, space in spaces.items():
            assert isinstance(space, Space), (
                f"Dict space element is not an instance of Space: key='{key}', space={space}"
            )

        self.spaces: dict[str, Space] = spaces
        super().__init__(None, None, seed)  # type: ignore[arg-type]

    @property
    def is_np_flattenable(self) -> bool:
        return all(space.is_np_flattenable for space in self.spaces.values())

    def seed(self, seed: int | dict[str, Any] | None = None) -> dict[str, Any]:
        """Seed all subspaces; returns the per-key entropies actually used."""
        if seed is None:
            return {key: space.seed(None) for key, space in self.spaces.items()}
        if isinstance(seed, int):
            super().seed(seed)
            subseeds = self.np_random.integers(np.iinfo(np.int32).max, size=len(self.spaces))
            return {
                key: space.seed(int(subseed))
                for (key, space), subseed in zip(self.spaces.items(), subseeds)
            }
        if isinstance(seed, dict):
            assert seed.keys() == self.spaces.keys(), (
                f"The seed keys {seed.keys()} must match the space keys {self.spaces.keys()}"
            )
            return {key: self.spaces[key].seed(seed[key]) for key in seed}
        raise TypeError(f"Expected seed type: dict, int or None, actual type: {type(seed)}")

    def sample(
        self,
        mask: dict[str, Any] | None = None,
        probability: dict[str, Any] | None = None,
    ) -> dict[str, Any]:
        if mask is not None and probability is not None:
            raise ValueError(
                f"Only one of `mask` or `probability` can be provided, actual values: mask={mask}, probability={probability}"
            )
        if mask is not None:
            assert isinstance(mask, dict) and mask.keys() == self.spaces.keys()
            return {key: self.spaces[key].sample(mask=mask[key]) for key in self.spaces}
        if probability is not None:
            assert isinstance(probability, dict) and probability.keys() == self.spaces.keys()
            return {
                key: self.spaces[key].sample(probability=probability[key]) for key in self.spaces
            }
        return {key: space.sample() for key, space in self.spaces.items()}

    def sample_torch(self, generator, batch_shape=(), device=None) -> dict[str, Any]:
        return {
            name: space.sample_torch(generator, batch_shape, device)
            for name, space in self.spaces.items()
        }

    def contains(self, x: Any) -> bool:
        if not isinstance(x, dict) or len(x) != len(self.spaces):
            return False
        return all(key in x and space.contains(x[key]) for key, space in self.spaces.items())

    def contains_torch(self, x) -> torch.Tensor:
        checks = [space.contains_torch(x[key]) for key, space in self.spaces.items()]
        # a Discrete answers lane by lane; the tree answers once
        return torch.stack([check.all() for check in checks]).all()

    def __getitem__(self, key: str) -> Space:
        return self.spaces[key]

    def __setitem__(self, key: str, value: Space):
        assert isinstance(value, Space), (
            f"Trying to set {key} to Dict space with value that is not a gymnasium space, actual type: {type(value)}"
        )
        self.spaces[key] = value

    def __iter__(self):
        yield from self.spaces

    def __len__(self) -> int:
        return len(self.spaces)

    def keys(self):
        return self.spaces.keys()

    def values(self):
        return self.spaces.values()

    def items(self):
        return self.spaces.items()

    def __repr__(self) -> str:
        return "Dict(" + ", ".join(f"{k!r}: {s}" for k, s in self.spaces.items()) + ")"

    def __eq__(self, other: Any) -> bool:
        return isinstance(other, Dict) and self.spaces == other.spaces

    def to_jsonable(self, sample_n: Sequence[dict[str, Any]]) -> dict[str, list]:
        return {
            key: space.to_jsonable([sample[key] for sample in sample_n])
            for key, space in self.spaces.items()
        }

    def from_jsonable(self, sample_n: dict[str, list]) -> list[dict[str, Any]]:
        dict_of_list = {
            key: space.from_jsonable(sample_n[key]) for key, space in self.spaces.items()
        }
        n_elements = len(next(iter(dict_of_list.values())))
        return [
            {key: value[n] for key, value in dict_of_list.items()} for n in range(n_elements)
        ]
