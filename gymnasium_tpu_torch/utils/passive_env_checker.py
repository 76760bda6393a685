"""Non-invasive API-conformance validators.

Copy of the JAX package's ``utils/passive_env_checker.py``, which follows
Gymnasium's (gymnasium/utils/passive_env_checker.py:56-312): the error and
warning strings are the contract, typos included. Observations may be
tensors on any device: a dtype is read as its numpy counterpart, and
membership goes through the spaces' ``contains``, which reads a device
tensor's answer once.
"""

from __future__ import annotations

import inspect
from functools import partial
from typing import Any, Callable

import numpy as np

import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.logger as logger
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.spaces.space import numpy_dtype

__all__ = [
    "check_space",
    "check_observation_space",
    "check_action_space",
    "env_reset_passive_checker",
    "env_step_passive_checker",
    "env_render_passive_checker",
]


# ---------------------------------------------------------------------------
# Space validation
# ---------------------------------------------------------------------------


def _check_box_observation_space(observation_space: spaces.Box):
    """Box observation sanity checks (the doubled 'have have' in the
    high-shape message is the reference's own)."""
    assert observation_space.low.shape == observation_space.shape, (
        f"The Box observation space shape and low shape have different shapes, low shape: {observation_space.low.shape}, box shape: {observation_space.shape}"
    )
    assert observation_space.high.shape == observation_space.shape, (
        f"The Box observation space shape and high shape have have different shapes, high shape: {observation_space.high.shape}, box shape: {observation_space.shape}"
    )
    if np.any(observation_space.low == observation_space.high):
        logger.warn("A Box observation space maximum and minimum values are equal.")
    elif np.any(observation_space.high < observation_space.low):
        logger.warn("A Box observation space low value is greater than a high value.")


def _check_box_action_space(action_space: spaces.Box):
    """Box action sanity checks (doubled 'have have' on the LOW side here —
    the reference's asymmetric typo)."""
    assert action_space.low.shape == action_space.shape, (
        f"The Box action space shape and low shape have have different shapes, low shape: {action_space.low.shape}, box shape: {action_space.shape}"
    )
    assert action_space.high.shape == action_space.shape, (
        f"The Box action space shape and high shape have different shapes, high shape: {action_space.high.shape}, box shape: {action_space.shape}"
    )
    if np.any(action_space.low == action_space.high):
        logger.warn("A Box action space maximum and minimum values are equal.")


def _validate_discrete(space, space_type, _box_fn, _recurse):
    assert 0 < space.n, (
        f"Discrete {space_type} space's number of elements must be positive, actual number of elements: {space.n}"
    )
    assert space.shape == (), (
        f"Discrete {space_type} space's shape should be empty, actual shape: {space.shape}"
    )


def _validate_multidiscrete(space, space_type, _box_fn, _recurse):
    assert space.shape == space.nvec.shape, (
        f"Multi-discrete {space_type} space's shape must be equal to the nvec shape, space shape: {space.shape}, nvec shape: {space.nvec.shape}"
    )
    assert np.all(0 < space.nvec), (
        f"Multi-discrete {space_type} space's all nvec elements must be greater than 0, actual nvec: {space.nvec}"
    )


def _validate_multibinary(space, space_type, _box_fn, _recurse):
    assert np.all(0 < np.asarray(space.shape)), (
        f"Multi-binary {space_type} space's all shape elements must be greater than 0, actual shape: {space.shape}"
    )


def _validate_tuple(space, space_type, box_fn, recurse):
    assert 0 < len(space.spaces), f"An empty Tuple {space_type} space is not allowed."
    for subspace in space.spaces:
        recurse(subspace, space_type, box_fn)


def _validate_dict(space, space_type, box_fn, recurse):
    assert 0 < len(space.spaces.keys()), f"An empty Dict {space_type} space is not allowed."
    for subspace in space.values():
        recurse(subspace, space_type, box_fn)


_SPACE_VALIDATORS: list[tuple[type, Callable]] = [
    (spaces.Box, lambda s, t, box_fn, _r: box_fn(s)),
    (spaces.Discrete, _validate_discrete),
    (spaces.MultiDiscrete, _validate_multidiscrete),
    (spaces.MultiBinary, _validate_multibinary),
    (spaces.Tuple, _validate_tuple),
    (spaces.Dict, _validate_dict),
]


def check_space(
    space: spaces.Space, space_type: str, check_box_space_fn: Callable[[spaces.Box], None]
):
    """Check that ``space`` is a valid space."""
    if not isinstance(space, spaces.Space):
        if str(space.__class__.__base__) == "<class 'gym.spaces.space.Space'>":
            raise TypeError(
                f"Gym is incompatible with Gymnasium, please update the environment {space_type}_space to `{str(space.__class__.__base__).replace('gym', 'gymnasium')}`."
            )
        raise TypeError(
            f"{space_type} space does not inherit from `gymnasium.spaces.Space`, actual type: {type(space)}"
        )
    for space_cls, validate in _SPACE_VALIDATORS:
        if isinstance(space, space_cls):
            validate(space, space_type, check_box_space_fn, check_space)
            return


check_observation_space = partial(
    check_space, space_type="observation", check_box_space_fn=_check_box_observation_space
)
check_action_space = partial(
    check_space, space_type="action", check_box_space_fn=_check_box_action_space
)


# ---------------------------------------------------------------------------
# Observation validation
# ---------------------------------------------------------------------------


def _arrayish(obs) -> bool:
    return isinstance(obs, np.ndarray) or hasattr(obs, "__array__")


def _obs_discrete(obs, space, pre, _m):
    if not isinstance(obs, (np.int64, int)):
        logger.warn(f"{pre} should be an int or np.int64, actual type: {type(obs)}")


def _obs_box(obs, space, pre, _m):
    if space.shape == ():
        return
    if not _arrayish(obs):
        logger.warn(f"{pre} was expecting a numpy array, actual type: {type(obs)}")
    elif hasattr(obs, "dtype") and numpy_dtype(obs.dtype) != space.dtype:
        logger.warn(
            f"{pre} was expecting numpy array dtype to be {space.dtype}, actual type: {obs.dtype}"
        )


def _obs_multi(obs, space, pre, _m):
    if not _arrayish(obs):
        logger.warn(f"{pre} was expecting a numpy array, actual type: {type(obs)}")


def _obs_tuple(obs, space, pre, method_name):
    if not isinstance(obs, tuple):
        logger.warn(f"{pre} was expecting a tuple, actual type: {type(obs)}")
        return
    assert len(obs) == len(space.spaces), (
        f"{pre} length is not same as the observation space length, obs length: {len(obs)}, space length: {len(space.spaces)}"
    )
    for sub_obs, sub_space in zip(obs, space.spaces):
        check_obs(sub_obs, sub_space, method_name)


def _obs_dict(obs, space, pre, method_name):
    assert isinstance(obs, dict), f"{pre} must be a dict, actual type: {type(obs)}"
    assert obs.keys() == space.spaces.keys(), (
        f"{pre} observation keys is not same as the observation space keys, obs keys: {list(obs.keys())}, space keys: {list(space.spaces.keys())}"
    )
    for space_key in space.spaces.keys():
        check_obs(obs[space_key], space[space_key], method_name)


_OBS_VALIDATORS: list[tuple[type, Callable]] = [
    (spaces.Discrete, _obs_discrete),
    (spaces.Box, _obs_box),
    ((spaces.MultiBinary, spaces.MultiDiscrete), _obs_multi),
    (spaces.Tuple, _obs_tuple),
    (spaces.Dict, _obs_dict),
]


def check_obs(obs: Any, observation_space: spaces.Space, method_name: str):
    """Check that ``obs`` is consistent with ``observation_space``."""
    pre = f"The obs returned by the `{method_name}()` method"
    for space_cls, validate in _OBS_VALIDATORS:
        if isinstance(observation_space, space_cls):
            validate(obs, observation_space, pre, method_name)
            break
    try:
        if obs not in observation_space:
            logger.warn(f"{pre} is not within the observation space.")
    except Exception as e:
        logger.warn(f"{pre} could not be checked against the observation space: {e}")


# ---------------------------------------------------------------------------
# reset / step / render checkers
# ---------------------------------------------------------------------------


def _check_reset_signature(env) -> None:
    params = inspect.signature(env.reset).parameters
    takes_kwargs = "kwargs" in params
    if "seed" not in params and not takes_kwargs:
        logger.deprecation(
            "Current gymnasium version requires that `Env.reset` can be passed a `seed` instead of using `Env.seed` for resetting the environment random number generator."
        )
    elif params.get("seed") is not None and params["seed"].default is not None:
        logger.warn(
            "The default seed argument in `Env.reset` should be `None`, otherwise the environment will by default always be deterministic. "
            f"Actual default: {params['seed']}"
        )
    if "options" not in params and not takes_kwargs:
        logger.deprecation(
            "Current gymnasium version requires that `Env.reset` can be passed `options` to allow the environment initialisation to be passed additional information."
        )


def env_reset_passive_checker(env, **kwargs: Any):
    """Check the env ``reset`` signature and returned values."""
    _check_reset_signature(env)
    result = env.reset(**kwargs)
    if not isinstance(result, tuple):
        logger.warn(
            f"The result returned by `env.reset()` was not a tuple of the form `(obs, info)`, where `obs` is a observation and `info` is a dictionary containing additional information. Actual type: `{type(result)}`"
        )
    elif len(result) != 2:
        logger.warn(
            "The result returned by `env.reset()` should be `(obs, info)` by default, , where `obs` is a observation and `info` is a dictionary containing additional information."
        )
    else:
        obs, info = result
        check_obs(obs, env.observation_space, "reset")
        assert isinstance(info, dict), (
            f"The second element returned by `env.reset()` was not a dictionary, actual type: {type(info)}"
        )
    return result


def _check_reward(reward) -> None:
    if not (
        np.issubdtype(type(reward), np.integer) or np.issubdtype(type(reward), np.floating)
    ):
        logger.warn(
            f"The reward returned by `step()` must be a float, int, np.integer or np.floating, actual type: {type(reward)}"
        )
    else:
        if np.isnan(reward):
            logger.warn("The reward is a NaN value.")
        if np.isinf(reward):
            logger.warn("The reward is an inf value.")


def _warn_non_bool(value, name: str) -> None:
    if not isinstance(value, (bool, np.bool_)):
        logger.warn(f"Expects `{name}` signal to be a boolean, actual type: {type(value)}")


def env_step_passive_checker(env, action: Any):
    """Check the env ``step`` returned values."""
    result = env.step(action)
    assert isinstance(result, tuple), (
        f"Expects step result to be a tuple, actual type: {type(result)}"
    )
    if len(result) == 4:
        logger.deprecation(
            "Core environment is written in old step API which returns one bool instead of two. "
            "It is recommended to rewrite the environment with new step API. "
        )
        obs, reward, done, info = result
        _warn_non_bool(done, "done")
    elif len(result) == 5:
        obs, reward, terminated, truncated, info = result
        _warn_non_bool(terminated, "terminated")
        _warn_non_bool(truncated, "truncated")
    else:
        raise gym.error.Error(
            f"Expected `Env.step` to return a four or five element tuple, actual number of elements returned: {len(result)}."
        )

    check_obs(obs, env.observation_space, "step")
    _check_reward(reward)
    assert isinstance(info, dict), (
        f"The `info` returned by `step()` must be a python dictionary, actual type: {type(info)}"
    )
    return result


def _check_render_metadata(env) -> None:
    render_modes = env.metadata.get("render_modes")
    if render_modes is None:
        logger.warn(
            "No render modes was declared in the environment (env.metadata['render_modes'] is None or not defined), you may have trouble when calling `.render()`."
        )
        return
    if not isinstance(render_modes, (list, tuple)):
        logger.warn(
            f"Expects the render_modes to be a sequence (i.e. list, tuple), actual type: {type(render_modes)}"
        )
    elif not all(isinstance(mode, str) for mode in render_modes):
        logger.warn(
            f"Expects all render modes to be strings, actual types: {[type(mode) for mode in render_modes]}"
        )

    render_fps = env.metadata.get("render_fps")
    if render_fps is None:
        logger.warn(
            "No render fps was declared in the environment (env.metadata['render_fps'] is None or not defined), rendering may occur at inconsistent fps."
        )
    elif not (
        np.issubdtype(type(render_fps), np.integer)
        or np.issubdtype(type(render_fps), np.floating)
    ):
        logger.warn(
            f"Expects the `env.metadata['render_fps']` to be an integer or a float, actual type: {type(render_fps)}"
        )
    else:
        assert render_fps > 0, (
            f"Expects the `env.metadata['render_fps']` to be greater than zero, actual value: {render_fps}"
        )

    if len(render_modes) == 0:
        assert env.render_mode is None, (
            f"With no render_modes, expects the Env.render_mode to be None, actual value: {env.render_mode}"
        )
    else:
        assert env.render_mode is None or env.render_mode in render_modes, (
            f"The environment was initialized successfully however with an unsupported render mode. Render mode: {env.render_mode}, modes: {render_modes}"
        )


def env_render_passive_checker(env):
    """Check the env ``render`` result against its declared render mode."""
    _check_render_metadata(env)
    result = env.render()
    if env.render_mode is not None:
        _check_render_return(env.render_mode, result)
    return result


def _check_render_return(render_mode: str, render_return: Any):
    """Check the return of ``render`` against its mode."""
    if render_mode == "human":
        if render_return is not None:
            logger.warn(f"Human rendering should return `None`, got {type(render_return)}")
    elif render_mode == "rgb_array":
        if not isinstance(render_return, np.ndarray):
            logger.warn(
                f"RGB-array rendering should return a numpy array, got {type(render_return)}"
            )
        else:
            if render_return.dtype != np.uint8:
                logger.warn(
                    f"RGB-array rendering should return a numpy array with dtype uint8, got {render_return.dtype}"
                )
            if render_return.ndim != 3 or render_return.shape[2] != 3:
                logger.warn(
                    f"RGB-array rendering should return a numpy array of shape (H, W, 3), got {render_return.shape}"
                )
    elif render_mode.endswith("_list"):
        if not isinstance(render_return, list):
            logger.warn(
                f"Render mode `{render_mode}` should return a list, got {type(render_return)}"
            )
        else:
            base_mode = render_mode[: -len("_list")]
            for item in render_return:
                _check_render_return(base_mode, item)
