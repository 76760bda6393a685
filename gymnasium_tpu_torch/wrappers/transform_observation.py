"""Stateless observation-transform wrappers (copy of the JAX package's
``wrappers/transform_observation.py``).

Parity surface: reference gymnasium/wrappers/transform_observation.py:43-830.
Image resizing is implemented with a numpy area/nearest resampler so no
native opencv dependency exists (the compute path never renders anyway).
"""

from __future__ import annotations

from typing import Any, Callable, Final, Sequence

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.core import ActType, ObsType
from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

__all__ = [
    "TransformObservation",
    "FilterObservation",
    "FlattenObservation",
    "GrayscaleObservation",
    "ResizeObservation",
    "ReshapeObservation",
    "RescaleObservation",
    "DtypeObservation",
    "AddRenderObservation",
    "DiscretizeObservation",
]


class TransformObservation(gym.ObservationWrapper, RecordConstructorArgs):
    """Apply ``func`` to every observation (reference transform_observation.py:43)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        func: Callable[[ObsType], Any],
        observation_space: gym.Space | None,
    ):
        RecordConstructorArgs.__init__(self, func=func, observation_space=observation_space)
        gym.ObservationWrapper.__init__(self, env)
        if observation_space is not None:
            self.observation_space = observation_space
        self.func = func

    def observation(self, observation: ObsType) -> Any:
        """Apply the transform."""
        return self.func(observation)


class FilterObservation(TransformObservation, RecordConstructorArgs):
    """Keep only a subset of Dict keys / Tuple indices
    (reference transform_observation.py:100)."""

    def __init__(self, env: gym.Env[ObsType, ActType], filter_keys: Sequence[str | int]):
        if not isinstance(filter_keys, Sequence):
            raise TypeError(
                f"Expects `filter_keys` to be a Sequence, actual type: {type(filter_keys)}"
            )
        RecordConstructorArgs.__init__(self, filter_keys=filter_keys)

        if isinstance(env.observation_space, spaces.Dict):
            assert all(isinstance(key, str) for key in filter_keys)
            missing_keys = [
                key for key in filter_keys if key not in env.observation_space.spaces.keys()
            ]
            if missing_keys:
                raise ValueError(
                    "All the `filter_keys` must be included in the observation space.\n"
                    f"Filter keys: {filter_keys}\n"
                    f"Observation keys: {list(env.observation_space.spaces.keys())}\n"
                    f"Missing keys: {missing_keys}"
                )
            new_space = spaces.Dict({key: env.observation_space[key] for key in filter_keys})
            if len(new_space) == 0:
                raise ValueError("The observation space is empty due to filtering all of the keys.")
            TransformObservation.__init__(
                self,
                env=env,
                func=lambda obs: {key: obs[key] for key in filter_keys},
                observation_space=new_space,
            )
        elif isinstance(env.observation_space, spaces.Tuple):
            assert all(isinstance(key, int) for key in filter_keys)
            assert len(set(filter_keys)) == len(filter_keys), (
                f"Duplicate keys exist, filter_keys: {filter_keys}"
            )
            if any(
                idx < 0 or idx >= len(env.observation_space.spaces) for idx in filter_keys
            ):
                raise ValueError(
                    f"All the `filter_keys` must be included in the length of the observation space.\n"
                    f"Filter keys: {filter_keys}, length of observation: {len(env.observation_space.spaces)}"
                )
            new_space = spaces.Tuple(
                [env.observation_space[idx] for idx in filter_keys]
            )
            if len(new_space.spaces) == 0:
                raise ValueError("The observation space is empty due to filtering all keys.")
            TransformObservation.__init__(
                self,
                env=env,
                func=lambda obs: tuple(obs[idx] for idx in filter_keys),
                observation_space=new_space,
            )
        else:
            raise ValueError(
                f"FilterObservation wrapper is only usable with `Dict` and `Tuple` observations, actual type: {type(env.observation_space)}"
            )
        self.filter_keys: Final = filter_keys


class FlattenObservation(TransformObservation, RecordConstructorArgs):
    """Flatten observations into 1-D (reference transform_observation.py:219)."""

    def __init__(self, env: gym.Env[ObsType, ActType]):
        RecordConstructorArgs.__init__(self)
        TransformObservation.__init__(
            self,
            env=env,
            func=lambda obs: spaces.flatten(env.observation_space, obs),
            observation_space=spaces.flatten_space(env.observation_space),
        )


class GrayscaleObservation(TransformObservation, RecordConstructorArgs):
    """RGB image observations to grayscale (reference transform_observation.py:259)."""

    def __init__(self, env: gym.Env[ObsType, ActType], keep_dim: bool = False):
        assert isinstance(env.observation_space, spaces.Box)
        assert (
            len(env.observation_space.shape) == 3
            and env.observation_space.shape[-1] == 3
        )
        assert (
            np.all(env.observation_space.low == 0)
            and np.all(env.observation_space.high == 255)
            and env.observation_space.dtype == np.uint8
        )
        RecordConstructorArgs.__init__(self, keep_dim=keep_dim)
        self.keep_dim: Final[bool] = keep_dim

        if keep_dim:
            new_space = spaces.Box(
                low=0,
                high=255,
                shape=env.observation_space.shape[:2] + (1,),
                dtype=np.uint8,
            )
            func = lambda obs: np.expand_dims(
                np.sum(np.multiply(obs, np.array([0.2125, 0.7154, 0.0721])), axis=-1).astype(
                    np.uint8
                ),
                axis=-1,
            )
        else:
            new_space = spaces.Box(
                low=0, high=255, shape=env.observation_space.shape[:2], dtype=np.uint8
            )
            func = lambda obs: np.sum(
                np.multiply(obs, np.array([0.2125, 0.7154, 0.0721])), axis=-1
            ).astype(np.uint8)
        TransformObservation.__init__(self, env=env, func=func, observation_space=new_space)


def _resize_image(image: np.ndarray, shape: tuple[int, int]) -> np.ndarray:
    """Area-average resize (nearest for upscale) without opencv."""
    in_h, in_w = image.shape[:2]
    out_h, out_w = shape
    # index maps via nearest-pixel sampling of the box centers
    rows = (np.arange(out_h) + 0.5) * in_h / out_h
    cols = (np.arange(out_w) + 0.5) * in_w / out_w
    row_idx = np.clip(rows.astype(int), 0, in_h - 1)
    col_idx = np.clip(cols.astype(int), 0, in_w - 1)
    if in_h >= 2 * out_h and in_w >= 2 * out_w:
        # clear downscale: average 2x2 neighborhoods around the centers
        r0 = np.clip(row_idx - 1, 0, in_h - 1)
        c0 = np.clip(col_idx - 1, 0, in_w - 1)
        acc = (
            image[row_idx][:, col_idx].astype(np.float32)
            + image[r0][:, col_idx]
            + image[row_idx][:, c0]
            + image[r0][:, c0]
        )
        return (acc / 4).astype(image.dtype)
    return image[row_idx][:, col_idx]


class ResizeObservation(TransformObservation, RecordConstructorArgs):
    """Resize image observations (reference transform_observation.py:339)."""

    def __init__(self, env: gym.Env[ObsType, ActType], shape: tuple[int, int]):
        assert isinstance(env.observation_space, spaces.Box)
        assert len(env.observation_space.shape) in (2, 3)
        assert np.all(env.observation_space.low == 0) and np.all(
            env.observation_space.high == 255
        )
        assert env.observation_space.dtype == np.uint8
        assert isinstance(shape, tuple)
        assert len(shape) == 2
        assert all(np.issubdtype(type(elem), np.integer) and elem > 0 for elem in shape)

        RecordConstructorArgs.__init__(self, shape=shape)
        self.shape: Final = tuple(shape)
        new_shape = tuple(shape) + env.observation_space.shape[2:]
        new_space = spaces.Box(low=0, high=255, shape=new_shape, dtype=np.uint8)
        TransformObservation.__init__(
            self,
            env=env,
            func=lambda obs: _resize_image(obs, self.shape),
            observation_space=new_space,
        )


class ReshapeObservation(TransformObservation, RecordConstructorArgs):
    """Reshape Box observations (reference transform_observation.py:410)."""

    def __init__(self, env: gym.Env[ObsType, ActType], shape: int | tuple[int, ...]):
        assert isinstance(env.observation_space, spaces.Box)
        shape = (shape,) if np.issubdtype(type(shape), np.integer) else tuple(shape)
        assert np.prod(shape) == np.prod(env.observation_space.shape)
        assert all(np.issubdtype(type(elem), np.integer) and elem > 0 for elem in shape)

        new_space = spaces.Box(
            low=np.reshape(env.observation_space.low, shape),
            high=np.reshape(env.observation_space.high, shape),
            shape=shape,
            dtype=env.observation_space.dtype,
        )
        self.shape = shape
        RecordConstructorArgs.__init__(self, shape=shape)
        TransformObservation.__init__(
            self,
            env=env,
            func=lambda obs: np.reshape(obs, shape),
            observation_space=new_space,
        )


class RescaleObservation(TransformObservation, RecordConstructorArgs):
    """Affinely rescale Box observations into ``[min_obs, max_obs]``; infinite
    components pass through (reference transform_observation.py:463-510)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        min_obs: np.floating | int | float | np.ndarray,
        max_obs: np.floating | int | float | np.ndarray,
    ):
        assert isinstance(env.observation_space, spaces.Box)

        RecordConstructorArgs.__init__(self, min_obs=min_obs, max_obs=max_obs)

        from gymnasium_tpu_torch.wrappers.utils import rescale_box

        obs_space, func, _ = rescale_box(env.observation_space, min_obs, max_obs)
        TransformObservation.__init__(
            self,
            env=env,
            func=func,
            observation_space=obs_space,
        )


class DtypeObservation(TransformObservation, RecordConstructorArgs):
    """Cast Box observations to a new dtype (reference transform_observation.py:513)."""

    def __init__(self, env: gym.Env[ObsType, ActType], dtype: Any):
        assert isinstance(
            env.observation_space,
            (spaces.Box, spaces.Discrete, spaces.MultiDiscrete, spaces.MultiBinary),
        )
        self.dtype = dtype
        if isinstance(env.observation_space, spaces.Box):
            new_space = spaces.Box(
                low=env.observation_space.low,
                high=env.observation_space.high,
                shape=env.observation_space.shape,
                dtype=self.dtype,
            )
        elif isinstance(env.observation_space, spaces.Discrete):
            new_space = spaces.Box(
                low=env.observation_space.start,
                high=env.observation_space.start + env.observation_space.n,
                shape=(),
                dtype=self.dtype,
            )
        elif isinstance(env.observation_space, spaces.MultiDiscrete):
            new_space = spaces.MultiDiscrete(env.observation_space.nvec, dtype=dtype)
        else:
            new_space = spaces.MultiBinary(env.observation_space.n)
            new_space.dtype = np.dtype(dtype)

        RecordConstructorArgs.__init__(self, dtype=dtype)
        TransformObservation.__init__(
            self,
            env=env,
            func=lambda obs: dtype(obs) if np.isscalar(obs) else np.asarray(obs, dtype=dtype),
            observation_space=new_space,
        )


class AddRenderObservation(TransformObservation, RecordConstructorArgs):
    """Include the rendered frame in the observation
    (reference transform_observation.py:580)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        render_only: bool = True,
        render_key: str = "pixels",
        obs_key: str = "state",
    ):
        RecordConstructorArgs.__init__(
            self, pixels_only=render_only, pixels_key=render_key, obs_key=obs_key
        )
        assert env.render_mode is not None and env.render_mode != "human"
        env.reset()
        pixels = env.render()
        assert pixels is not None and isinstance(pixels, np.ndarray)
        pixel_space = spaces.Box(low=0, high=255, shape=pixels.shape, dtype=np.uint8)

        if render_only:
            obs_space = pixel_space
            func = lambda _: self.render()
        elif isinstance(env.observation_space, spaces.Dict):
            assert render_key not in env.observation_space.spaces.keys()
            obs_space = spaces.Dict({render_key: pixel_space, **env.observation_space.spaces})
            func = lambda obs: {render_key: self.render(), **obs}
        else:
            obs_space = spaces.Dict({obs_key: env.observation_space, render_key: pixel_space})
            func = lambda obs: {obs_key: obs, render_key: self.render()}
        TransformObservation.__init__(self, env=env, func=func, observation_space=obs_space)


class DiscretizeObservation(gym.ObservationWrapper, RecordConstructorArgs):
    """Uniformly bin a finite Box observation space
    (reference transform_observation.py:688)."""

    def __init__(
        self,
        env: gym.Env[ObsType, ActType],
        bins: int | tuple[int, ...],
        multidiscrete: bool = False,
    ):
        if not isinstance(env.observation_space, spaces.Box):
            raise TypeError(
                "DiscretizeObservation is only compatible with Box continuous observations."
            )
        self.low = env.observation_space.low
        self.high = env.observation_space.high
        self.n_dims = self.low.shape[0]
        if np.any(np.isinf(self.low)) or np.any(np.isinf(self.high)):
            raise ValueError(
                "Discretization requires observation space to be finite. "
                f"Found: low={self.low}, high={self.high}"
            )
        self.multidiscrete = multidiscrete
        RecordConstructorArgs.__init__(self, bins=bins)
        gym.ObservationWrapper.__init__(self, env)

        if isinstance(bins, int):
            self.bins = np.array([bins] * self.n_dims)
        else:
            assert len(bins) == self.n_dims, (
                f"bins must match action dimensions: expected {self.n_dims}, got {len(bins)}"
            )
            self.bins = np.array(bins)

        self.bin_edges = [
            np.linspace(self.low[i], self.high[i], self.bins[i] + 1)[1:-1]
            for i in range(self.n_dims)
        ]
        if self.multidiscrete:
            self.observation_space = spaces.MultiDiscrete(self.bins)
        else:
            self.observation_space = spaces.Discrete(int(np.prod(self.bins)))

    def observation(self, observation):
        """Bin the observation (clipped so high-bound values stay in range)."""
        clipped = np.clip(observation, self.low, self.high - 1e-8)
        indices = [
            int(np.digitize(clipped[i], self.bin_edges[i])) for i in range(self.n_dims)
        ]
        if self.multidiscrete:
            return np.array(indices, dtype=np.int64)
        flat = 0
        for i in range(self.n_dims):
            flat = flat * int(self.bins[i]) + indices[i]
        return int(flat)

    def revert_observation(self, obs):
        """Bounds of the bin that a discretized observation belongs to."""
        if self.multidiscrete:
            indices = np.asarray(obs, dtype=int)
        else:
            indices = []
            rem = int(obs)
            for i in reversed(range(self.n_dims)):
                indices.append(rem % int(self.bins[i]))
                rem //= int(self.bins[i])
            indices = list(reversed(indices))
        lows, highs = [], []
        for i, idx in enumerate(indices):
            edges = np.linspace(self.low[i], self.high[i], self.bins[i] + 1)
            lows.append(edges[idx])
            highs.append(edges[idx + 1])
        return (
            np.array(lows, dtype=self.env.observation_space.dtype),
            np.array(highs, dtype=self.env.observation_space.dtype),
        )
