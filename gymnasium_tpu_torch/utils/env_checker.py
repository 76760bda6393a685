"""Active environment conformance checker (copy of the JAX package's
``utils/env_checker.py``).

Parity surface: reference gymnasium/utils/env_checker.py:73-351 —
reset/step determinism under the same seed, reset signature/options
handling, space membership, and return-type validation. The warnings and
exceptions are the JAX package's, word for word.

An env whose ``metadata["torch"]`` is true (the port's functional envs,
which hand back tensors on their device) is checked through
``ArrayConversion(env, env_xp="torch", target_xp="numpy")``, as the JAX
package checks a ``"jax"`` env through ``JaxToNumpy``.
"""

from __future__ import annotations

import inspect
from copy import deepcopy

import numpy as np

import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.logger as logger
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.utils.data_equivalence import data_equivalence
from gymnasium_tpu_torch.utils.passive_env_checker import (
    check_action_space,
    check_observation_space,
    env_render_passive_checker,
    env_reset_passive_checker,
    env_step_passive_checker,
)

__all__ = ["check_env", "data_equivalence"]


def check_reset_return_info_deprecation(env: gym.Env):
    """Warn if ``reset`` still takes the long-removed ``return_info`` argument
    (reference env_checker.py:255-269)."""
    signature = inspect.signature(env.reset)
    if "return_info" in signature.parameters:
        logger.warn(
            "`return_info` is deprecated as an optional argument to `reset`. `reset`"
            "should now always return `obs, info` where `obs` is an observation, and `info` is a dictionary"
            "containing additional information."
        )


def check_seed_deprecation(env: gym.Env):
    """Warn if the env still exposes a callable ``seed`` method
    (reference env_checker.py:272-285)."""
    if callable(getattr(env, "seed", None)):
        logger.warn(
            "Official support for the `seed` function is dropped. "
            "Standard practice is to reset gymnasium environments using `env.reset(seed=<desired seed>)`"
        )


def check_reset_return_type(env: gym.Env):
    """Check ``reset`` returns an ``(obs, info)`` 2-tuple
    (reference env_checker.py:288-310)."""
    result = env.reset()
    assert isinstance(result, tuple), (
        f"The result returned by `env.reset()` was not a tuple of the form `(obs, info)`, where `obs` is a observation and `info` is a dictionary containing additional information. Actual type: `{type(result)}`"
    )
    assert len(result) == 2, (
        f"Calling the reset method did not return a 2-tuple, actual length: {len(result)}"
    )
    obs, info = result
    assert obs in env.observation_space, (
        "The first element returned by `env.reset()` is not within the observation space."
    )
    assert isinstance(info, dict), (
        f"The second element returned by `env.reset()` was not a dictionary, actual type: {type(info)}"
    )


def check_space_limit(space, space_type: str):
    """Warn on unbounded or non-normalised Box spaces; recurses into
    composites (reference env_checker.py:313-348)."""
    if isinstance(space, spaces.Box):
        if np.any(np.equal(space.low, -np.inf)):
            logger.warn(
                f"A Box {space_type} space minimum value is -infinity. This is probably too low."
            )
        if np.any(np.equal(space.high, np.inf)):
            logger.warn(
                f"A Box {space_type} space maximum value is infinity. This is probably too high."
            )
        if space_type == "action" and len(space.shape) == 1:
            if (
                np.any(
                    np.logical_and(
                        space.low != np.zeros_like(space.low),
                        np.abs(space.low) != np.abs(space.high),
                    )
                )
                or np.any(space.low < -1)
                or np.any(space.high > 1)
            ):
                logger.warn(
                    "For Box action spaces, we recommend using a symmetric and normalized space (range=[-1, 1] or [0, 1]). "
                    "See https://stable-baselines3.readthedocs.io/en/master/guide/rl_tips.html for more information."
                )
    elif isinstance(space, spaces.Tuple):
        for subspace in space.spaces:
            check_space_limit(subspace, space_type)
    elif isinstance(space, spaces.Dict):
        for subspace in space.values():
            check_space_limit(subspace, space_type)


def check_reset_seed_determinism(env: gym.Env):
    """Check seeded reset determinism: same seed → same obs and PRNG state,
    different seed → different PRNG state, unseeded resets reproducible
    after re-seeding, and the ``seed`` default must be ``None``
    (reference env_checker.py:73-163)."""
    signature = inspect.signature(env.reset)
    if "seed" not in signature.parameters and not (
        "kwargs" in signature.parameters
        and signature.parameters["kwargs"].kind is inspect.Parameter.VAR_KEYWORD
    ):
        raise gym.error.Error(
            "The `reset` method does not provide a `seed` or `**kwargs` keyword argument."
        )

    try:
        obs_1, info = env.reset(seed=123)
        assert obs_1 in env.observation_space, (
            "The observation returned by `env.reset(seed=123)` is not within the observation space."
        )
        assert env.unwrapped._np_random is not None, (
            "Expects the random number generator to have been generated given a seed was passed to reset. Most likely the environment reset function does not call `super().reset(seed=seed)`."
        )
        seed_123_rng_1 = deepcopy(env.unwrapped._np_random)

        obs_2, info = env.reset()
        assert obs_2 in env.observation_space, (
            "The observation returned by `env.reset()` is not within the observation space."
        )

        obs_3, info = env.reset(seed=123)
        assert obs_3 in env.observation_space, (
            "The observation returned by `env.reset(seed=123)` is not within the observation space."
        )
        seed_123_rng_3 = deepcopy(env.unwrapped._np_random)

        obs_4, info = env.reset()
        assert obs_4 in env.observation_space, (
            "The observation returned by `env.reset()` is not within the observation space."
        )

        if env.spec is not None and env.spec.nondeterministic is False:
            assert data_equivalence(obs_1, obs_3), (
                "Using `env.reset(seed=123)` is non-deterministic as the observations are not equivalent."
            )
            assert data_equivalence(obs_2, obs_4), (
                "Using `env.reset(seed=123)` then `env.reset()` is non-deterministic as the observations are not equivalent."
            )
            if not data_equivalence(obs_1, obs_3, exact=True):
                logger.warn(
                    "Using `env.reset(seed=123)` observations are not equal although similar."
                )
            if not data_equivalence(obs_2, obs_4, exact=True):
                logger.warn(
                    "Using `env.reset(seed=123)` then `env.reset()` observations are not equal although similar."
                )

        assert (
            seed_123_rng_1.bit_generator.state == seed_123_rng_3.bit_generator.state
        ), (
            "Most likely the environment reset function does not call `super().reset(seed=seed)` as the random generates are not same when the same seeds are passed to `env.reset`."
        )

        obs_5, info = env.reset(seed=456)
        assert obs_5 in env.observation_space, (
            "The observation returned by `env.reset(seed=456)` is not within the observation space."
        )
        assert (
            env.unwrapped._np_random.bit_generator.state
            != seed_123_rng_1.bit_generator.state
        ), (
            "Most likely the environment reset function does not call `super().reset(seed=seed)` as the random number generators are not different when different seeds are passed to `env.reset`."
        )
    except TypeError as e:
        raise AssertionError(
            "The environment cannot be reset with a random seed, even though `seed` or `kwargs` appear in the signature. "
            f"This should never happen, please report this issue. The error was: {e}"
        ) from e

    seed_param = signature.parameters.get("seed")
    if seed_param is not None and seed_param.default is not None:
        logger.warn(
            "The default seed argument in reset should be `None`, otherwise the environment will by default always be deterministic. "
            f"Actual default: {seed_param.default}"
        )


def check_reset_options(env: gym.Env):
    """Check that reset accepts an ``options`` keyword."""
    signature = inspect.signature(env.reset)
    if "options" not in signature.parameters and "kwargs" not in signature.parameters:
        raise gym.error.Error(
            "The `reset` method does not provide an `options` or `**kwargs` keyword argument."
        )
    env.reset(options={})


def check_step_determinism(env: gym.Env, seed: int = 123):
    """Check obs/reward/termination/info and PRNG state are identical for the
    same seed and action (reference env_checker.py:194-253)."""
    if env.spec is not None and env.spec.nondeterministic:
        return

    env.action_space.seed(seed)
    action = env.action_space.sample()

    env.reset(seed=seed)
    obs_0, rew_0, term_0, trunc_0, info_0 = env.step(action)
    seeded_rng = deepcopy(env.unwrapped._np_random)

    env.reset(seed=seed)
    obs_1, rew_1, term_1, trunc_1, info_1 = env.step(action)

    assert (
        env.unwrapped._np_random.bit_generator.state
        == seeded_rng.bit_generator.state
    ), "The `.np_random` is not properly been updated after step."

    assert data_equivalence(obs_0, obs_1), (
        "Deterministic step observations are not equivalent for the same seed and action"
    )
    if not data_equivalence(obs_0, obs_1, exact=True):
        logger.warn(
            "Step observations are not equal although similar given the same seed and action"
        )

    assert data_equivalence(rew_0, rew_1), (
        "Deterministic step rewards are not equivalent for the same seed and action"
    )
    if not data_equivalence(rew_0, rew_1, exact=True):
        logger.warn(
            "Step rewards are not equal although similar given the same seed and action"
        )

    assert data_equivalence(term_0, term_1, exact=True), (
        "Deterministic step termination are not equivalent for the same seed and action"
    )
    assert trunc_0 is False and trunc_1 is False, (
        "Environment truncates after 1 step, something has gone very wrong."
    )

    assert data_equivalence(info_0, info_1), (
        "Deterministic step info are not equivalent for the same seed and action"
    )
    if not data_equivalence(info_0, info_1, exact=True):
        logger.warn(
            "Step info are not equal although similar given the same seed and action"
        )


def check_env(
    env: gym.Env,
    warn: bool | None = None,
    skip_render_check: bool = False,
    skip_close_check: bool = False,
):
    """Run the full battery of API conformance checks on ``env``
    (check order and messages per reference env_checker.py:351-452)."""
    if warn is not None:
        logger.warn("`check_env(warn=...)` parameter is now ignored.")

    if not isinstance(env, gym.Env):
        if str(env.__class__.__base__) in (
            "<class 'gym.core.Env'>",
            "<class 'gym.core.Wrapper'>",
        ):
            raise TypeError(
                "Gym is incompatible with Gymnasium, please update the environment class to `gymnasium.Env`. "
                "See https://gymnasium.farama.org/introduction/create_custom_env/ for more info."
            )
        raise TypeError(
            f"The environment must inherit from the gymnasium.Env class, actual class: {type(env)}. "
            "See https://gymnasium.farama.org/introduction/create_custom_env/ for more info."
        )

    if env.unwrapped is not env:
        logger.warn(
            f"The environment ({env}) is different from the unwrapped version ({env.unwrapped}). This could effect the environment checker as the environment most likely has a wrapper applied to it. We recommend using the raw environment for `check_env` using `env.unwrapped`."
        )

    if env.metadata.get("jax", False):
        env = gym.wrappers.JaxToNumpy(env)
    elif env.metadata.get("torch", False):
        env = gym.wrappers.ArrayConversion(env, env_xp="torch", target_xp="numpy")

    if not hasattr(env, "action_space"):
        raise AttributeError(
            "The environment must specify an action space. See https://gymnasium.farama.org/introduction/create_custom_env/ for more info."
        )
    check_action_space(env.action_space)
    check_space_limit(env.action_space, "action")

    if not hasattr(env, "observation_space"):
        raise AttributeError(
            "The environment must specify an observation space. See https://gymnasium.farama.org/introduction/create_custom_env/ for more info."
        )
    check_observation_space(env.observation_space)
    check_space_limit(env.observation_space, "observation")

    check_seed_deprecation(env)
    check_reset_return_info_deprecation(env)
    check_reset_return_type(env)
    check_reset_seed_determinism(env)
    check_reset_options(env)

    env_reset_passive_checker(env)
    env_step_passive_checker(env, env.action_space.sample())

    check_step_determinism(env)

    if not skip_render_check:
        if env.render_mode is not None:
            env_render_passive_checker(env)

        if env.spec is not None:
            for render_mode in env.metadata["render_modes"]:
                new_env = env.spec.make(render_mode=render_mode)
                new_env.reset()
                env_render_passive_checker(new_env)
                new_env.close()
        else:
            logger.warn(
                "Not able to test alternative render modes due to the environment not having a spec. Try instantiating the environment through `gymnasium.make`"
            )

    if not skip_close_check and env.spec is not None:
        new_env = env.spec.make()
        new_env.close()
        try:
            new_env.close()
        except Exception as e:
            logger.warn(
                f"Calling `env.close()` on the closed environment should be allowed, but it raised an exception: {e}"
            )
