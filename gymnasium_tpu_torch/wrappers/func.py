"""Functional wrappers: pure transforms whose state rides along with the env carry.

Counterpart of the JAX package's ``wrappers/func.py``. Every wrapper is a
state-carrying transform

    ``update(wrapper_state, timestep, reset_mask, env_carry)
        -> (wrapper_state, timestep)``

whose state is a tree of tensors threaded through the step beside the
:class:`~gymnasium_tpu_torch.functional.EnvCarry`. :func:`wrap_autoreset_step`
folds a wrapper stack into the ``(carry, action) -> (carry, timestep)`` step
of :func:`~gymnasium_tpu_torch.functional.make_autoreset_step`, so
observation and reward normalisation and episode statistics run on the
batch's device inside the vector env or the PPO train step, and no step
reads a value back to the host.

Reset semantics follow NEXT_STEP autoreset: the step after a done is the
reset step (reward 0, flags False, obs = reset obs), and each wrapper gets
that step's ``reset_mask`` (the pre-step ``prev_done``).

Ported so far: the core, the running statistics, ``NormalizeObservation``,
``NormalizeReward`` and ``EpisodeStatistics``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.functional import EnvCarry, TimeStep, tree_map

__all__ = [
    "FuncWrapper",
    "WrappedEnvCarry",
    "wrap_autoreset_step",
    "wrap_initial",
    "wrapped_spaces",
    "RmsState",
    "rms_init",
    "rms_update",
    "NormalizeObservation",
    "NormalizeReward",
    "NormalizeRewardState",
    "EpisodeStatistics",
    "EpisodeStatsState",
    "episode_stats_to_infos",
]


class FuncWrapper:
    """A pure environment transform with an explicit state tree.

    Hooks (defaults are identity and stateless):

    - ``init(rng, obs, carry, params) -> (wrapper_state, obs)``: build the
      state from the batch's initial observation and transform it.
    - ``transform_action(wrapper_state, action) -> (wrapper_state, action)``:
      pre-step action transform (outermost wrapper first).
    - ``update(wrapper_state, timestep, reset_mask, env_carry)
      -> (wrapper_state, timestep)``: post-step transform of the
      :class:`TimeStep` (innermost wrapper first). ``reset_mask`` is True on
      lanes whose step was an autoreset step; ``env_carry`` is the post-step
      :class:`EnvCarry`.
    """

    def init(self, rng: torch.Generator, obs: Any, carry: EnvCarry, params: Any = None):
        return None, obs

    def transform_action(self, wstate: Any, action: Any):
        return wstate, action

    def update(self, wstate: Any, ts: TimeStep, reset_mask: torch.Tensor, carry: EnvCarry):
        return wstate, ts

    def observation_space(self, space: Any) -> Any:
        """The (single-env) observation space after this wrapper."""
        return space

    def action_space(self, space: Any) -> Any:
        """The (single-env) action space this wrapper accepts."""
        return space

    def state_per_env(self, wstate: Any, num_envs: int) -> Any:
        """Tree of bools marking which state leaves carry the env axis.

        A masked reset takes the fresh value on the reset lanes of a per-env
        leaf and keeps a shared leaf's live value. The default infers it from
        the leading dimension; a wrapper whose shared state could have a
        leading dimension of ``num_envs`` by coincidence overrides this.
        """
        return tree_map(
            lambda leaf: isinstance(leaf, torch.Tensor) and leaf.dim() > 0 and leaf.shape[0] == num_envs,
            wstate,
        )


class WrappedEnvCarry(NamedTuple):
    """:class:`EnvCarry` plus one state tree per wrapper (innermost first)."""

    env: EnvCarry
    wrappers: tuple[Any, ...]


def wrapped_spaces(func_env: Any, wrappers: Sequence[FuncWrapper]) -> tuple[Any, Any]:
    """The (single-env) observation and action spaces of ``func_env`` seen
    through the wrapper stack."""
    obs_space, act_space = func_env.observation_space, func_env.action_space
    for w in wrappers:
        obs_space = w.observation_space(obs_space)
        act_space = w.action_space(act_space)
    return obs_space, act_space


def wrap_initial(
    wrappers: Sequence[FuncWrapper],
    rng: torch.Generator,
    carry: EnvCarry,
    obs: Any,
    params: Any = None,
) -> tuple[WrappedEnvCarry, Any]:
    """Initialise every wrapper state from the batch's reset observation.

    Where the JAX version splits a key per wrapper, every wrapper draws from
    ``rng``, which advances.
    """
    states = []
    for w in wrappers:
        wstate, obs = w.init(rng, obs, carry, params)
        states.append(wstate)
    return WrappedEnvCarry(env=carry, wrappers=tuple(states)), obs


def wrap_autoreset_step(
    step_fn: Callable[[EnvCarry, Any], tuple[EnvCarry, TimeStep]],
    wrappers: Sequence[FuncWrapper],
) -> Callable[[WrappedEnvCarry, Any], tuple[WrappedEnvCarry, TimeStep]]:
    """Fold a wrapper stack (innermost first) into an autoreset step.

    Actions flow outermost to innermost; observations and rewards flow
    innermost to outermost, as in ``w_outer(w_inner(env))``.
    """
    wrappers = tuple(wrappers)

    def step(carry: WrappedEnvCarry, action: Any) -> tuple[WrappedEnvCarry, TimeStep]:
        reset_mask = carry.env.prev_done
        states = list(carry.wrappers)
        for i in range(len(wrappers) - 1, -1, -1):
            states[i], action = wrappers[i].transform_action(states[i], action)
        env_carry, ts = step_fn(carry.env, action)
        for i, w in enumerate(wrappers):
            states[i], ts = w.update(states[i], ts, reset_mask, env_carry)
        return WrappedEnvCarry(env=env_carry, wrappers=tuple(states)), ts

    return step


# ---------------------------------------------------------------------------
# Running mean and variance as a state tree
# ---------------------------------------------------------------------------


class RmsState(NamedTuple):
    """Chan parallel-variance statistics: ``mean``, ``var`` (population),
    ``count`` (a float32 0-d tensor) and ``update_flag`` (a bool 0-d tensor
    that freezes the statistics when False, without a branch on the host)."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor
    update_flag: torch.Tensor


def rms_init(
    shape: tuple[int, ...] = (),
    epsilon: float = 1e-4,
    dtype: torch.dtype = torch.float32,
    device: str | torch.device | None = None,
) -> RmsState:
    """Fresh statistics, as the host ``RunningMeanStd(epsilon, shape)``."""
    return RmsState(
        mean=torch.zeros(shape, dtype=dtype, device=device),
        var=torch.ones(shape, dtype=dtype, device=device),
        count=torch.tensor(epsilon, dtype=dtype, device=device),
        update_flag=torch.tensor(True, device=device),
    )


def rms_update(rms: RmsState, batch: torch.Tensor) -> RmsState:
    """Fold a batch (leading axis) into the statistics by the Chan et al.
    merge. No change where ``update_flag`` is False."""
    batch_mean = batch.mean(dim=0)
    # jnp.var is the population variance
    batch_var = batch.var(dim=0, correction=0)
    batch_count = batch.shape[0]

    delta = batch_mean - rms.mean
    tot = rms.count + batch_count
    new_mean = rms.mean + delta * batch_count / tot
    m2 = rms.var * rms.count + batch_var * batch_count + torch.square(delta) * rms.count * batch_count / tot
    keep = rms.update_flag
    return RmsState(
        mean=torch.where(keep, new_mean, rms.mean),
        var=torch.where(keep, m2 / tot, rms.var),
        count=torch.where(keep, tot, rms.count),
        update_flag=rms.update_flag,
    )


def _freeze(rms: RmsState, frozen: bool = True) -> RmsState:
    return rms._replace(update_flag=torch.tensor(not frozen, device=rms.update_flag.device))


def _shared(wstate: Any) -> Any:
    return tree_map(lambda _: False, wstate)


# ---------------------------------------------------------------------------
# Stateful wrappers
# ---------------------------------------------------------------------------


class NormalizeObservation(FuncWrapper):
    """Normalise the batched observation by one running mean and std.

    The statistics are shared by the whole batch and updated with it every
    step, reset steps included. Freeze them with
    ``wstate = NormalizeObservation.freeze(wstate)``.
    """

    def __init__(self, epsilon: float = 1e-8, dtype: torch.dtype = torch.float32):
        self.epsilon = epsilon
        self.dtype = dtype

    @staticmethod
    def freeze(wstate: RmsState, frozen: bool = True) -> RmsState:
        """Stop (or resume) updating the running statistics."""
        return _freeze(wstate, frozen)

    def _normalize(self, rms: RmsState, obs: torch.Tensor) -> torch.Tensor:
        return ((obs - rms.mean) / torch.sqrt(rms.var + self.epsilon)).to(self.dtype)

    def init(self, rng, obs, carry, params=None):
        rms = rms_update(rms_init(tuple(obs.shape[1:]), dtype=self.dtype, device=obs.device), obs)
        return rms, self._normalize(rms, obs)

    def update(self, wstate, ts, reset_mask, carry):
        rms = rms_update(wstate, ts.obs)
        return rms, ts._replace(obs=self._normalize(rms, ts.obs))

    def observation_space(self, space):
        return spaces.Box(-np.inf, np.inf, shape=space.shape, dtype=str(self.dtype).removeprefix("torch."))

    def state_per_env(self, wstate, num_envs):
        # shared by the batch, whatever the obs width
        return _shared(wstate)


class NormalizeRewardState(NamedTuple):
    rms: RmsState
    accumulated: torch.Tensor  # (N,) discounted-return accumulator


class NormalizeReward(FuncWrapper):
    """Scale rewards by the running std of the discounted return.

    ``acc = acc * gamma * (1 - terminated) + reward``; the statistics are
    updated with the accumulator batch and the reward divided by
    ``sqrt(var + eps)``. Truncation does not zero the accumulator, as in the
    reference; a reset step's reward is 0, so a reset lane adds
    ``acc * gamma``.
    """

    def __init__(self, gamma: float = 0.99, epsilon: float = 1e-8):
        self.gamma = gamma
        self.epsilon = epsilon

    @staticmethod
    def freeze(wstate: NormalizeRewardState, frozen: bool = True) -> NormalizeRewardState:
        """Stop (or resume) updating the running return statistics."""
        return wstate._replace(rms=_freeze(wstate.rms, frozen))

    def init(self, rng, obs, carry, params=None):
        done = carry.prev_done
        accumulated = torch.zeros(done.shape[0], dtype=torch.float32, device=done.device)
        return NormalizeRewardState(rms_init((), device=done.device), accumulated), obs

    def update(self, wstate, ts, reset_mask, carry):
        acc = wstate.accumulated * self.gamma * (1.0 - ts.terminated.to(torch.float32)) + ts.reward
        rms = rms_update(wstate.rms, acc)
        reward = ts.reward / torch.sqrt(rms.var + self.epsilon)
        return NormalizeRewardState(rms, acc), ts._replace(reward=reward)

    def state_per_env(self, wstate, num_envs):
        # shared return statistics, per-env accumulator
        return NormalizeRewardState(rms=_shared(wstate.rms), accumulated=True)


# ---------------------------------------------------------------------------
# Episode statistics on the device
# ---------------------------------------------------------------------------


class EpisodeStatsState(NamedTuple):
    episode_return: torch.Tensor  # (N,) float32, running return of the live episode
    episode_length: torch.Tensor  # (N,) int32, running length of the live episode


class EpisodeStatistics(FuncWrapper):
    """Accumulate each env's episode return and length on the device and
    report them in ``TimeStep.info`` when the episode ends.

    Fixed-shape info keys: ``episode_return`` ((N,) float32, the finished
    episode's return on done lanes, 0 elsewhere), ``episode_length`` ((N,)
    int32, likewise) and ``_episode`` ((N,) bool, the done mask). Convert to
    the reference's info dict with :func:`episode_stats_to_infos`.
    """

    def init(self, rng, obs, carry, params=None):
        done = carry.prev_done
        n = done.shape[0]
        return (
            EpisodeStatsState(
                torch.zeros(n, dtype=torch.float32, device=done.device),
                torch.zeros(n, dtype=torch.int32, device=done.device),
            ),
            obs,
        )

    def update(self, wstate, ts, reset_mask, carry):
        # a reset step zeroes the lane's statistics; other steps accumulate
        live = ~reset_mask
        ep_ret = torch.where(live, wstate.episode_return + ts.reward, 0.0)
        ep_len = torch.where(live, wstate.episode_length + 1, 0)
        done = ts.terminated | ts.truncated
        info = dict(ts.info)
        info["episode_return"] = torch.where(done, ep_ret, 0.0)
        info["episode_length"] = torch.where(done, ep_len, 0)
        info["_episode"] = done
        return EpisodeStatsState(ep_ret, ep_len), ts._replace(info=info)


def _host(x: Any) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def episode_stats_to_infos(info: dict[str, Any]) -> dict[str, Any]:
    """Convert one step's fixed-shape episode info into the reference's vector
    info format: ``{"episode": {"r", "l"}, "_episode": mask}`` when at least
    one episode finished, else no episode keys. Reads the values back to the
    host.
    """
    mask = _host(info["_episode"])
    passthrough = {
        k: v for k, v in info.items() if k not in ("episode_return", "episode_length", "_episode")
    }
    if not mask.any():
        return passthrough
    passthrough["episode"] = {
        "r": np.where(mask, _host(info["episode_return"]), 0.0),
        "l": np.where(mask, _host(info["episode_length"]), 0),
    }
    passthrough["_episode"] = mask
    return passthrough
