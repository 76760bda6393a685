"""SyncVectorEnv: serial host-side vectorization of arbitrary Python envs
(copy of the JAX package's ``vector/sync_vector_env.py``).

It behaves as Gymnasium's (gymnasium/vector/sync_vector_env.py:26-378):
batched buffers, the three autoreset modes, masked partial reset,
call/get/set broadcast. The internals are the JAX package's: the autoreset
policy is selected ONCE at construction as a per-env step closure
(the same pattern as the async worker's ``_stepper_for``), and reset is
split into full/masked paths sharing one seed normalizer.

The sub-envs are what ``make(id)`` builds: numpy classes, or classes that
step on the card one env at a time and hand back numpy. So the batch is
numpy, as the JAX package's is. The batched device path is
:class:`~gymnasium_tpu_torch.vector.TorchVectorEnv`.
"""

from __future__ import annotations

from copy import deepcopy
from typing import Any, Callable, Iterator, Sequence

import numpy as np

from gymnasium_tpu_torch import Env, Space
from gymnasium_tpu_torch.spaces.utils import is_space_dtype_shape_equiv
from gymnasium_tpu_torch.vector.utils import (
    batch_differing_spaces,
    batch_space,
    concatenate,
    create_empty_array,
    iterate,
)
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv

__all__ = ["SyncVectorEnv"]


def _normalize_seeds(seed, num_envs: int) -> list[int | None]:
    if seed is None:
        return [None] * num_envs
    if isinstance(seed, int):
        return [seed + i for i in range(num_envs)]
    seeds = list(seed)
    assert len(seeds) == num_envs, (
        f"If seeds are passed as a list the length must match num_envs={num_envs} but got length={len(seeds)}."
    )
    return seeds


def _validate_reset_mask(mask, num_envs: int) -> None:
    assert isinstance(mask, np.ndarray), (
        f"`options['reset_mask': mask]` must be a numpy array, got {type(mask)}"
    )
    assert mask.shape == (num_envs,), (
        f"`options['reset_mask': mask]` must have shape `({num_envs},)`, got {mask.shape}"
    )
    assert mask.dtype == np.bool_, (
        f"`options['reset_mask': mask]` must have `dtype=np.bool_`, got {mask.dtype}"
    )
    assert np.any(mask), (
        f"`options['reset_mask': mask]` must contain a boolean array, got reset_mask={mask}"
    )


class SyncVectorEnv(VectorEnv):
    """Serially-stepped batched environment in a single process."""

    def __init__(
        self,
        env_fns: Iterator[Callable[[], Env]] | Sequence[Callable[[], Env]],
        copy: bool = True,
        observation_mode: str | Space = "same",
        autoreset_mode: str | AutoresetMode = AutoresetMode.NEXT_STEP,
    ):
        super().__init__()
        self.env_fns = env_fns
        self.copy = copy
        self.observation_mode = observation_mode
        self.autoreset_mode = (
            AutoresetMode(autoreset_mode)
            if isinstance(autoreset_mode, str)
            else autoreset_mode
        )
        assert isinstance(self.autoreset_mode, AutoresetMode)

        self.envs = [env_fn() for env_fn in env_fns]
        self.num_envs = len(self.envs)
        # a copy: the sub-env's metadata is its class's dict, which the
        # autoreset mode written below must not reach
        self.metadata = deepcopy(self.envs[0].metadata)
        self.metadata["autoreset_mode"] = self.autoreset_mode
        self.render_mode = self.envs[0].render_mode

        self._resolve_spaces(observation_mode)
        self._check_sub_env_spaces(observation_mode)

        self._observations = create_empty_array(
            self.single_observation_space, n=self.num_envs, fn=np.zeros
        )
        self._rewards = np.zeros((self.num_envs,), dtype=np.float64)
        self._terminations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._truncations = np.zeros((self.num_envs,), dtype=np.bool_)
        self._needs_autoreset = np.zeros((self.num_envs,), dtype=np.bool_)

        self._step_one = self._make_step_policy()

    # -- construction helpers ----------------------------------------------

    def _resolve_spaces(self, mode) -> None:
        self.single_action_space = self.envs[0].action_space
        self.action_space = batch_space(self.single_action_space, self.num_envs)
        if isinstance(mode, tuple) and len(mode) == 2:
            assert isinstance(mode[0], Space) and isinstance(mode[1], Space)
            self.observation_space, self.single_observation_space = mode
        elif mode == "same":
            self.single_observation_space = self.envs[0].observation_space
            self.observation_space = batch_space(
                self.single_observation_space, self.num_envs
            )
        elif mode == "different":
            self.single_observation_space = self.envs[0].observation_space
            self.observation_space = batch_differing_spaces(
                [env.observation_space for env in self.envs]
            )
        else:
            raise ValueError(
                f"Invalid `observation_mode`, expected: 'same' or 'different' or tuple of single and batch observation space, actual got {mode}"
            )

    def _check_sub_env_spaces(self, mode) -> None:
        for env in self.envs:
            if mode == "same":
                assert env.observation_space == self.single_observation_space, (
                    f"SyncVectorEnv(..., observation_mode='same') however the sub-environments observation spaces are not equivalent. single_observation_space={self.single_observation_space}, sub-environment observation_space={env.observation_space}. If this is intentional, use `observation_mode='different'` instead."
                )
            else:
                assert is_space_dtype_shape_equiv(
                    env.observation_space, self.single_observation_space
                ), (
                    f"SyncVectorEnv(..., observation_mode='different' or custom space) however the sub-environments observation spaces do not share a common shape and dtype, single_observation_space={self.single_observation_space}, sub-environment observation space={env.observation_space}"
                )
            assert env.action_space == self.single_action_space, (
                f"Sub-environment action space doesn't make the `single_action_space`, action_space={env.action_space}, single_action_space={self.single_action_space}"
            )

    def _make_step_policy(self):
        """Per-env ``step(i, action) -> (obs, info, extra_infos)`` closure,
        chosen once by autoreset mode (mode dispatch outside the loop)."""

        def record(i, result):
            obs, self._rewards[i], self._terminations[i], self._truncations[i], info = result
            return obs, info

        if self.autoreset_mode == AutoresetMode.NEXT_STEP:

            def step_one(i, action):
                # the step after a done ignores the action and resets
                if self._needs_autoreset[i]:
                    obs, info = self.envs[i].reset()
                    self._rewards[i] = 0.0
                    self._terminations[i] = False
                    self._truncations[i] = False
                    return obs, info, None
                return (*record(i, self.envs[i].step(action)), None)

        elif self.autoreset_mode == AutoresetMode.SAME_STEP:

            def step_one(i, action):
                obs, info = record(i, self.envs[i].step(action))
                if self._terminations[i] or self._truncations[i]:
                    final = {"final_obs": obs, "final_info": info}
                    obs, info = self.envs[i].reset()
                    return obs, info, final
                return obs, info, None

        elif self.autoreset_mode == AutoresetMode.DISABLED:

            def step_one(i, action):
                assert not self._needs_autoreset[i], (
                    f"Environment {i} is done and AutoresetMode is DISABLED; call `reset` with a reset_mask."
                )
                return (*record(i, self.envs[i].step(action)), None)

        else:
            raise ValueError(f"Unexpected autoreset mode, {self.autoreset_mode}")

        return step_one

    # -- properties ---------------------------------------------------------

    @property
    def np_random_seed(self) -> tuple[int, ...]:
        """Seeds of all sub-environments."""
        return self.get_attr("np_random_seed")

    @property
    def np_random(self) -> tuple[np.random.Generator, ...]:
        """Generators of all sub-environments."""
        return self.get_attr("np_random")

    # -- reset --------------------------------------------------------------

    def reset(
        self,
        *,
        seed: int | list[int | None] | None = None,
        options: dict[str, Any] | None = None,
    ):
        """Reset all (or a masked subset of) sub-environments."""
        seeds = _normalize_seeds(seed, self.num_envs)
        if options is not None and "reset_mask" in options:
            mask = options.pop("reset_mask")
            _validate_reset_mask(mask, self.num_envs)
            return self._reset_masked(seeds, options, mask)
        return self._reset_all(seeds, options)

    def _reset_all(self, seeds, options):
        self._terminations[:] = False
        self._truncations[:] = False
        self._needs_autoreset[:] = False
        obs_list, infos = [], {}
        for i, (env, env_seed) in enumerate(zip(self.envs, seeds)):
            obs, info = env.reset(seed=env_seed, options=options)
            obs_list.append(obs)
            infos = self._add_info(infos, info, i)
        self._observations = concatenate(
            self.single_observation_space, obs_list, self._observations
        )
        return self._batched_obs(), infos

    def _reset_masked(self, seeds, options, mask):
        self._terminations[mask] = False
        self._truncations[mask] = False
        self._needs_autoreset[mask] = False
        infos: dict[str, Any] = {}
        # splice freshly-reset observations into the existing batch
        obs_list = list(iterate(self.observation_space, self._observations))
        for i in np.flatnonzero(mask):
            obs_list[i], info = self.envs[i].reset(seed=seeds[i], options=options)
            infos = self._add_info(infos, info, i)
        self._observations = concatenate(
            self.single_observation_space, obs_list, self._observations
        )
        return self._batched_obs(), infos

    # -- step ---------------------------------------------------------------

    def step(self, actions):
        """Step all sub-envs serially under the configured autoreset policy."""
        obs_list, infos = [], {}
        # strict zip raises ValueError on an action-count mismatch
        for i, (action, _) in enumerate(zip(iterate(self.action_space, actions), self.envs, strict=True)):
            obs, info, final = self._step_one(i, action)
            if final is not None:
                infos = self._add_info(infos, final, i)
            obs_list.append(obs)
            infos = self._add_info(infos, info, i)

        self._observations = concatenate(
            self.single_observation_space, obs_list, self._observations
        )
        self._needs_autoreset = np.logical_or(self._terminations, self._truncations)
        return (
            self._batched_obs(),
            np.copy(self._rewards),
            np.copy(self._terminations),
            np.copy(self._truncations),
            infos,
        )

    def _batched_obs(self):
        return deepcopy(self._observations) if self.copy else self._observations

    # -- broadcast ----------------------------------------------------------

    def render(self) -> tuple | None:
        """Render all sub-envs, returning a tuple of frames."""
        return tuple(env.render() for env in self.envs)

    def call(self, name: str, *args: Any, **kwargs: Any) -> tuple[Any, ...]:
        """Call a method (or read an attribute) on every sub-env."""
        results = []
        for env in self.envs:
            attr = env.get_wrapper_attr(name)
            results.append(attr(*args, **kwargs) if callable(attr) else attr)
        return tuple(results)

    def get_attr(self, name: str) -> tuple[Any, ...]:
        """Read attribute ``name`` from every sub-env."""
        return self.call(name)

    def set_attr(self, name: str, values: list[Any] | tuple[Any, ...] | Any):
        """Set attribute ``name`` on every sub-env."""
        if not isinstance(values, (list, tuple)):
            values = [values] * self.num_envs
        if len(values) != self.num_envs:
            raise ValueError(
                "Values must be a list or tuple with length equal to the number of environments. "
                f"Got `{len(values)}` values for {self.num_envs} environments."
            )
        for env, value in zip(self.envs, values):
            env.set_wrapper_attr(name, value)

    def close_extras(self, **kwargs: Any):
        if hasattr(self, "envs"):
            [env.close() for env in self.envs]
