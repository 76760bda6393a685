"""VectorEnv base protocol, autoreset modes, and vector wrapper bases.

Copy of the JAX package's ``vector/vector_env.py``, which follows
Gymnasium's (gymnasium/vector/vector_env.py:32-600): the batched step/reset
API, the ``AutoresetMode`` enum, the ``_add_info`` masked info batching
protocol, and the VectorWrapper family.
"""

from __future__ import annotations

from enum import Enum
from typing import TYPE_CHECKING, Any, Generic, TypeVar

import numpy as np

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils import seeding

if TYPE_CHECKING:
    from gymnasium_tpu_torch.envs.registration import EnvSpec

__all__ = [
    "VectorEnv",
    "VectorWrapper",
    "VectorObservationWrapper",
    "VectorActionWrapper",
    "VectorRewardWrapper",
    "AutoresetMode",
    "ArrayType",
]

ArrayType = TypeVar("ArrayType")
ObsType = TypeVar("ObsType")
ActType = TypeVar("ActType")


class AutoresetMode(Enum):
    """When episode-ending sub-envs are reset (reference vector_env.py:32-37)."""

    NEXT_STEP = "NextStep"
    SAME_STEP = "SameStep"
    DISABLED = "Disabled"


class VectorEnv(Generic[ObsType, ActType, ArrayType]):
    """Batched environment: N lockstep sub-environments behind one step call.

    The port's implementation is device-resident
    (:class:`gymnasium_tpu_torch.vector.TorchVectorEnv`).
    """

    metadata: dict[str, Any] = {}
    spec: EnvSpec | None = None
    render_mode: str | None = None
    closed: bool = False

    observation_space: spaces.Space
    action_space: spaces.Space
    single_observation_space: spaces.Space
    single_action_space: spaces.Space

    num_envs: int

    _np_random: np.random.Generator | None = None
    _np_random_seed: int | None = None

    def reset(
        self,
        *,
        seed: int | None = None,
        options: dict[str, Any] | None = None,
    ) -> tuple[ObsType, dict[str, Any]]:
        """Reset all sub-environments, returning batched obs and info."""
        if seed is not None:
            self._np_random, self._np_random_seed = seeding.np_random(seed)
        return None, {}  # type: ignore[return-value]

    def step(
        self, actions: ActType
    ) -> tuple[ObsType, ArrayType, ArrayType, ArrayType, dict[str, Any]]:
        """Step all sub-environments with batched ``actions``."""
        raise NotImplementedError(f"{self.__str__()} step function is not implemented.")

    def render(self) -> tuple | None:
        """Render the sub-environments."""
        raise NotImplementedError(f"{self.__str__()} render function is not implemented.")

    def close(self, **kwargs: Any):
        """Close all sub-environments (idempotent)."""
        if self.closed:
            return
        self.close_extras(**kwargs)
        self.closed = True

    def close_extras(self, **kwargs: Any):
        """Clean up resources beyond what :meth:`close` does by default."""
        pass

    # -- RNG ---------------------------------------------------------------

    @property
    def np_random(self) -> np.random.Generator:
        """Lazily-initialised PCG64 generator."""
        if self._np_random is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator):
        self._np_random = value
        self._np_random_seed = -1

    @property
    def np_random_seed(self) -> int | None:
        """Seed of the env's PRNG (-1 if the generator was set directly)."""
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random_seed

    @property
    def unwrapped(self):
        """The base VectorEnv."""
        return self

    # -- info batching protocol (reference vector_env.py:275-336) ----------

    def _add_info(self, vector_infos: dict[str, Any], env_info: dict[str, Any], env_num: int) -> dict[str, Any]:
        """Merge one sub-env's info dict into the batched info dict.

        Scalar/array values become ``(num_envs,)`` arrays plus a boolean
        ``_key`` presence mask; nested dicts recurse.
        """
        for key, value in env_info.items():
            # `final_obs` stays an unbatched object array (None for envs that
            # did not finish) so users can index per-env observations
            # (reference vector_env.py:293-300).
            if key == "final_obs":
                if "final_obs" in vector_infos:
                    array = vector_infos["final_obs"]
                else:
                    array = np.full(self.num_envs, fill_value=None, dtype=object)
                array[env_num] = value
            elif isinstance(value, dict):
                array = self._add_info(vector_infos.get(key, {}), value, env_num)
            else:
                if key not in vector_infos:
                    if type(value) in [int, float, bool] or issubclass(
                        type(value), np.number
                    ):
                        array = np.zeros(self.num_envs, dtype=type(value))
                    elif isinstance(value, np.ndarray):
                        array = np.zeros((self.num_envs, *value.shape), dtype=value.dtype)
                    else:
                        array = np.full(self.num_envs, fill_value=None, dtype=object)
                else:
                    array = vector_infos[key]
                array[env_num] = value

            array_mask = vector_infos.get(f"_{key}", np.zeros(self.num_envs, dtype=np.bool_))
            array_mask[env_num] = True
            vector_infos[key], vector_infos[f"_{key}"] = array, array_mask
        return vector_infos

    def __del__(self):
        if not getattr(self, "closed", True):
            try:
                self.close()
            except Exception:
                pass

    def __repr__(self) -> str:
        if self.spec is None:
            return f"{self.__class__.__name__}(num_envs={self.num_envs})"
        return f"{self.__class__.__name__}({self.spec.id}, num_envs={self.num_envs})"


class VectorWrapper(VectorEnv):
    """Delegating proxy around a :class:`VectorEnv`."""

    def __init__(self, env: VectorEnv):
        self.env = env
        assert isinstance(env, VectorEnv), f"Expected env to be a `VectorEnv` but got {type(env)}"
        self._observation_space: spaces.Space | None = None
        self._action_space: spaces.Space | None = None
        self._single_observation_space: spaces.Space | None = None
        self._single_action_space: spaces.Space | None = None
        self._metadata: dict[str, Any] | None = None

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        return self.env.reset(seed=seed, options=options)

    def step(self, actions):
        return self.env.step(actions)

    def render(self):
        return self.env.render()

    def close(self, **kwargs: Any):
        return self.env.close(**kwargs)

    def close_extras(self, **kwargs: Any):
        return self.env.close_extras(**kwargs)

    @property
    def unwrapped(self):
        return self.env.unwrapped

    @property
    def observation_space(self) -> spaces.Space:
        if self._observation_space is None:
            return self.env.observation_space
        return self._observation_space

    @observation_space.setter
    def observation_space(self, space: spaces.Space):
        self._observation_space = space

    @property
    def action_space(self) -> spaces.Space:
        if self._action_space is None:
            return self.env.action_space
        return self._action_space

    @action_space.setter
    def action_space(self, space: spaces.Space):
        self._action_space = space

    @property
    def single_observation_space(self) -> spaces.Space:
        if self._single_observation_space is None:
            return self.env.single_observation_space
        return self._single_observation_space

    @single_observation_space.setter
    def single_observation_space(self, space: spaces.Space):
        self._single_observation_space = space

    @property
    def single_action_space(self) -> spaces.Space:
        if self._single_action_space is None:
            return self.env.single_action_space
        return self._single_action_space

    @single_action_space.setter
    def single_action_space(self, space: spaces.Space):
        self._single_action_space = space

    @property
    def num_envs(self) -> int:
        return self.env.num_envs

    @property
    def np_random(self) -> np.random.Generator:
        return self.env.np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator):
        self.env.np_random = value

    @property
    def np_random_seed(self) -> int | None:
        return self.env.np_random_seed

    @property
    def metadata(self) -> dict[str, Any]:
        if self._metadata is None:
            return self.env.metadata
        return self._metadata

    @metadata.setter
    def metadata(self, value: dict[str, Any]):
        self._metadata = value

    @property
    def spec(self) -> EnvSpec | None:
        return self.env.spec

    @property
    def render_mode(self) -> str | None:
        return self.env.render_mode

    def __repr__(self) -> str:
        return f"<{self.__class__.__name__}, {self.env}>"


class VectorObservationWrapper(VectorWrapper):
    """Vector wrapper that only transforms batched observations."""

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        observations, infos = self.env.reset(seed=seed, options=options)
        return self.observations(observations), infos

    def step(self, actions):
        observations, rewards, terminations, truncations, infos = self.env.step(actions)
        return self.observations(observations), rewards, terminations, truncations, infos

    def observations(self, observations: ObsType) -> ObsType:
        """Transform a batch of observations."""
        raise NotImplementedError


class VectorActionWrapper(VectorWrapper):
    """Vector wrapper that only transforms batched actions."""

    def step(self, actions: ActType):
        return self.env.step(self.actions(actions))

    def actions(self, actions: ActType) -> ActType:
        """Transform a batch of actions."""
        raise NotImplementedError


class VectorRewardWrapper(VectorWrapper):
    """Vector wrapper that only transforms batched rewards."""

    def step(self, actions):
        observations, rewards, terminations, truncations, infos = self.env.step(actions)
        return observations, self.rewards(rewards), terminations, truncations, infos

    def rewards(self, rewards: ArrayType) -> ArrayType:
        """Transform a batch of rewards."""
        raise NotImplementedError
