"""Core environment protocol: the stateful host-side shell.

Copy of the JAX package's ``core.py``, which follows Gymnasium's
(gymnasium/core.py:73-646): the 5-tuple ``step``, ``reset(seed, options)``,
``render``, ``close``, lazy PCG64 ``np_random``, ``Wrapper`` delegation with
lazily-overridable spaces, and the one-hook
``ObservationWrapper``/``RewardWrapper``/``ActionWrapper`` subclasses.

This stateful class is a thin shell. The compute path of the port is the
functional API (:mod:`gymnasium_tpu_torch.functional`), whose batch-first
hooks run on the device; ``Env`` keeps single-env host code, the checkers
and the wrappers on the familiar interface.
"""

from __future__ import annotations

from copy import deepcopy
from typing import TYPE_CHECKING, Any, Generic, SupportsFloat, TypeVar

import numpy as np

from gymnasium_tpu_torch import error, spaces
from gymnasium_tpu_torch.utils import seeding

if TYPE_CHECKING:
    from gymnasium_tpu_torch.envs.registration import EnvSpec, WrapperSpec

ObsType = TypeVar("ObsType")
ActType = TypeVar("ActType")
RenderFrame = TypeVar("RenderFrame")
WrapperObsType = TypeVar("WrapperObsType")
WrapperActType = TypeVar("WrapperActType")

__all__ = [
    "Env",
    "Wrapper",
    "ObservationWrapper",
    "RewardWrapper",
    "ActionWrapper",
    "ObsType",
    "ActType",
    "RenderFrame",
]


class Env(Generic[ObsType, ActType]):
    """The main stateful environment class implementing the step/reset API.

    The step API returns the 5-tuple ``(obs, reward, terminated, truncated,
    info)``. Seeding follows the reference semantics: ``reset(seed=...)``
    reseeds the internal PCG64 generator; with ``seed=None`` the existing
    generator is kept (and lazily created on first use).
    """

    metadata: dict[str, Any] = {"render_modes": []}
    render_mode: str | None = None
    spec: EnvSpec | None = None

    observation_space: spaces.Space[ObsType]
    action_space: spaces.Space[ActType]

    _np_random: np.random.Generator | None = None
    # Seed recorded when np_random was created (-1 => generator was set
    # directly and the seed is unknown).
    _np_random_seed: int | None = None

    def step(self, action: ActType) -> tuple[ObsType, SupportsFloat, bool, bool, dict[str, Any]]:
        """Run one timestep of the environment's dynamics using ``action``."""
        raise NotImplementedError

    def reset(
        self,
        *,
        seed: int | None = None,
        options: dict[str, Any] | None = None,
    ) -> tuple[ObsType, dict[str, Any]]:
        """Reset to an initial state; reseeds the PRNG when ``seed`` is given.

        Subclasses must call ``super().reset(seed=seed)`` first to get the
        seeding behavior.
        """
        if seed is not None:
            self._np_random, self._np_random_seed = seeding.np_random(seed)
        return None, {}  # type: ignore[return-value]

    def render(self) -> RenderFrame | list[RenderFrame] | None:
        """Render according to ``render_mode`` set at construction."""
        raise NotImplementedError

    def close(self):
        """Release any resources held by the environment."""
        pass

    # -- RNG ---------------------------------------------------------------

    @property
    def np_random_seed(self) -> int:
        """Seed of the env's internal PRNG (-1 if unknown)."""
        if self._np_random_seed is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random_seed

    @property
    def np_random(self) -> np.random.Generator:
        """Lazily-initialised PCG64 generator."""
        if self._np_random is None:
            self._np_random, self._np_random_seed = seeding.np_random()
        return self._np_random

    @np_random.setter
    def np_random(self, value: np.random.Generator) -> None:
        self._np_random = value
        self._np_random_seed = -1

    # -- introspection -----------------------------------------------------

    @property
    def unwrapped(self) -> Env[ObsType, ActType]:
        """The base non-wrapped environment."""
        return self

    def __str__(self) -> str:
        if self.spec is None:
            return f"<{type(self).__name__} instance>"
        return f"<{type(self).__name__}<{self.spec.id}>>"

    def __enter__(self):
        return self

    def __exit__(self, *args: Any):
        self.close()
        return False

    # -- wrapper attribute helpers (reference core.py:267-280) -------------

    def has_wrapper_attr(self, name: str) -> bool:
        """Whether the (unwrapped) env has attribute ``name``."""
        return hasattr(self, name)

    def get_wrapper_attr(self, name: str) -> Any:
        """Get attribute ``name`` from the env."""
        return getattr(self, name)

    def set_wrapper_attr(self, name: str, value: Any, *, force: bool = True) -> bool:
        """Set attribute ``name`` on the env; returns whether it was set."""
        if force or hasattr(self, name):
            setattr(self, name, value)
            return True
        return False


class Wrapper(Env[WrapperObsType, WrapperActType], Generic[WrapperObsType, WrapperActType, ObsType, ActType]):
    """Delegating proxy around an :class:`Env` with lazily-overridable spaces."""

    def __init__(self, env: Env[ObsType, ActType]):
        self.env = env
        assert isinstance(env, Env), f"Expected env to be a `gymnasium_tpu_torch.Env` but got {type(env)}"

        self._action_space: spaces.Space[WrapperActType] | None = None
        self._observation_space: spaces.Space[WrapperObsType] | None = None
        self._metadata: dict[str, Any] | None = None
        self._cached_spec: EnvSpec | None = None

    def step(
        self, action: WrapperActType
    ) -> tuple[WrapperObsType, SupportsFloat, bool, bool, dict[str, Any]]:
        return self.env.step(action)  # type: ignore[arg-type, return-value]

    def reset(
        self, *, seed: int | None = None, options: dict[str, Any] | None = None
    ) -> tuple[WrapperObsType, dict[str, Any]]:
        return self.env.reset(seed=seed, options=options)  # type: ignore[return-value]

    def render(self) -> RenderFrame | list[RenderFrame] | None:
        return self.env.render()

    def close(self):
        return self.env.close()

    # -- spec with wrapper stack (reference core.py:356-402) ---------------

    @property
    def spec(self) -> EnvSpec | None:
        """Env spec with this wrapper appended (when reconstructible)."""
        if self._cached_spec is not None:
            return self._cached_spec

        env_spec = self.env.spec
        if env_spec is not None:
            from gymnasium_tpu_torch.envs.registration import WrapperSpec
            from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs

            if isinstance(self, RecordConstructorArgs):
                kwargs = getattr(self, "_saved_kwargs")
                if "env" in kwargs:
                    kwargs = {k: v for k, v in kwargs.items() if k != "env"}
                wrapper_spec = WrapperSpec(
                    name=type(self).__name__,
                    entry_point=f"{type(self).__module__}:{type(self).__name__}",
                    kwargs=kwargs,
                )
            else:
                wrapper_spec = WrapperSpec(
                    name=type(self).__name__,
                    entry_point=f"{type(self).__module__}:{type(self).__name__}",
                    kwargs=None,
                )

            # deepcopy can fail on unpicklable user kwargs — warn and return
            # None rather than raising (reference core.py:380-388)
            try:
                env_spec = deepcopy(env_spec)
                env_spec.additional_wrappers += (wrapper_spec,)
            except Exception as e:
                import gymnasium_tpu_torch.logger as logger

                logger.warn(
                    f"An exception occurred ({e}) while copying the environment spec={env_spec}"
                )
                return None
        self._cached_spec = env_spec
        return env_spec

    @classmethod
    def wrapper_spec(cls, **kwargs: Any) -> WrapperSpec:
        """A :class:`WrapperSpec` for this wrapper class with ``kwargs``."""
        from gymnasium_tpu_torch.envs.registration import WrapperSpec

        return WrapperSpec(
            name=cls.__name__,
            entry_point=f"{cls.__module__}:{cls.__name__}",
            kwargs=kwargs,
        )

    # -- wrapper-stack attribute access -------------------------------------
    # NOTE: deliberately NO `__getattr__` forwarding (reference core.py:404-453
    # dropped it in 1.x): a plain `wrapper.attr` miss raises AttributeError and
    # the `_np_random` property below raises its redirect message un-masked.

    def has_wrapper_attr(self, name: str) -> bool:
        """Search the wrapper stack for attribute ``name``."""
        if hasattr(self, name):
            return True
        return self.env.has_wrapper_attr(name)

    def get_wrapper_attr(self, name: str) -> Any:
        """Get ``name`` from the first wrapper (outside-in) that has it."""
        if hasattr(self, name):
            return getattr(self, name)
        try:
            return self.env.get_wrapper_attr(name)
        except AttributeError as e:
            raise AttributeError(
                f"wrapper {self.class_name()} has no attribute {name!r}"
            ) from e

    def set_wrapper_attr(self, name: str, value: Any, *, force: bool = True) -> bool:
        """Set ``name`` on the first wrapper that already has it (or here)."""
        if hasattr(self, name):
            setattr(self, name, value)
            return True
        set_on_inner = self.env.set_wrapper_attr(name, value, force=False)
        if not set_on_inner and force:
            setattr(self, name, value)
            return True
        return set_on_inner

    # -- lazily overridable properties (reference core.py:468-503) ---------

    @property
    def action_space(self) -> spaces.Space[ActType] | spaces.Space[WrapperActType]:
        if self._action_space is None:
            return self.env.action_space
        return self._action_space

    @action_space.setter
    def action_space(self, space: spaces.Space[WrapperActType]):
        self._action_space = space

    @property
    def observation_space(self) -> spaces.Space[ObsType] | spaces.Space[WrapperObsType]:
        if self._observation_space is None:
            return self.env.observation_space
        return self._observation_space

    @observation_space.setter
    def observation_space(self, space: spaces.Space[WrapperObsType]):
        self._observation_space = space

    @property
    def metadata(self) -> dict[str, Any]:
        if self._metadata is None:
            return self.env.metadata
        return self._metadata

    @metadata.setter
    def metadata(self, value: dict[str, Any]):
        self._metadata = value

    @property
    def render_mode(self) -> str | None:
        return self.env.render_mode

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
    def _np_random(self):
        raise AttributeError(
            "Can't access `_np_random` of a wrapper, use `.unwrapped._np_random` or `.np_random`."
        )

    @property
    def unwrapped(self) -> Env[ObsType, ActType]:
        return self.env.unwrapped

    def __str__(self) -> str:
        return f"<{type(self).__name__}{self.env}>"

    def __repr__(self) -> str:
        return str(self)

    @classmethod
    def class_name(cls) -> str:
        """The class name of the wrapper."""
        return cls.__name__


class ObservationWrapper(Wrapper[WrapperObsType, ActType, ObsType, ActType]):
    """Wrapper that only transforms observations via :meth:`observation`."""

    def reset(
        self, *, seed: int | None = None, options: dict[str, Any] | None = None
    ) -> tuple[WrapperObsType, dict[str, Any]]:
        obs, info = self.env.reset(seed=seed, options=options)
        return self.observation(obs), info

    def step(
        self, action: ActType
    ) -> tuple[WrapperObsType, SupportsFloat, bool, bool, dict[str, Any]]:
        observation, reward, terminated, truncated, info = self.env.step(action)
        return self.observation(observation), reward, terminated, truncated, info

    def observation(self, observation: ObsType) -> WrapperObsType:
        """Map an observation to its transformed value."""
        raise NotImplementedError


class RewardWrapper(Wrapper[ObsType, ActType, ObsType, ActType]):
    """Wrapper that only transforms rewards via :meth:`reward`."""

    def step(
        self, action: ActType
    ) -> tuple[ObsType, SupportsFloat, bool, bool, dict[str, Any]]:
        observation, reward, terminated, truncated, info = self.env.step(action)
        return observation, self.reward(reward), terminated, truncated, info

    def reward(self, reward: SupportsFloat) -> SupportsFloat:
        """Map a reward to its transformed value."""
        raise NotImplementedError


class ActionWrapper(Wrapper[ObsType, WrapperActType, ObsType, ActType]):
    """Wrapper that only transforms actions via :meth:`action`."""

    def step(
        self, action: WrapperActType
    ) -> tuple[ObsType, SupportsFloat, bool, bool, dict[str, Any]]:
        return self.env.step(self.action(action))

    def action(self, action: WrapperActType) -> ActType:
        """Map a wrapper action to the inner env's action."""
        raise NotImplementedError
