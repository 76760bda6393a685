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

Every functional wrapper of the JAX package is here: the running
statistics with ``NormalizeObservation`` and ``NormalizeReward``,
``FrameStackObservation``, ``TimeAwareObservation``, ``DelayObservation``,
``StickyAction``, the ``Transform*``, ``Clip*`` and ``Rescale*`` transforms,
and ``EpisodeStatistics``.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Sequence

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.functional import EnvCarry, TimeStep, _lanes, tree_map
from gymnasium_tpu_torch.utils.device import to_host

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
    "FrameStackObservation",
    "TimeAwareObservation",
    "DelayObservation",
    "DelayObservationState",
    "StickyAction",
    "StickyActionState",
    "TransformObservation",
    "TransformAction",
    "TransformReward",
    "ClipAction",
    "ClipReward",
    "RescaleAction",
    "RescaleObservation",
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


class FrameStackObservation(FuncWrapper):
    """Stack the last ``stack_size`` observations along a new axis 1.

    Output obs ``(N, stack, *obs_shape)``, oldest frame first. ``padding_type``
    ``"reset"`` pads a fresh episode with copies of its reset observation,
    ``"zero"`` with zeros. The state is the rolling buffer.
    """

    def __init__(self, stack_size: int, padding_type: str = "reset"):
        if stack_size < 1:
            raise ValueError(f"stack_size must be >= 1, got {stack_size}")
        if padding_type not in ("reset", "zero"):
            raise ValueError(f"padding_type must be 'reset' or 'zero', got {padding_type!r}")
        self.stack_size = stack_size
        self.padding_type = padding_type

    def _fresh(self, obs):
        # padding in slots [0, stack - 1), the new obs last
        pad = obs if self.padding_type == "reset" else torch.zeros_like(obs)
        return torch.stack([pad] * (self.stack_size - 1) + [obs], dim=1)

    def init(self, rng, obs, carry, params=None):
        buf = self._fresh(obs)
        return buf, buf

    def update(self, wstate, ts, reset_mask, carry):
        obs = ts.obs
        rolled = torch.cat([wstate[:, 1:], obs[:, None]], dim=1)
        buf = torch.where(_lanes(reset_mask, rolled), self._fresh(obs), rolled)
        return buf, ts._replace(obs=buf)

    def observation_space(self, space):
        from gymnasium_tpu_torch.vector.utils import batch_space  # the vector env imports this module

        return batch_space(space, self.stack_size)


class TimeAwareObservation(FuncWrapper):
    """Append the in-episode step counter to a flat Box observation.

    Time is 0 at reset and grows by one a step (``EnvCarry.steps``);
    ``normalize_time=True`` divides it by ``max_episode_steps``. Stateless.
    """

    def __init__(self, normalize_time: bool = False, max_episode_steps: int | None = None):
        if normalize_time and max_episode_steps is None:
            raise ValueError("normalize_time=True requires max_episode_steps")
        self.normalize_time = normalize_time
        self.max_episode_steps = max_episode_steps

    def _with_time(self, obs, steps):
        t = steps.to(obs.dtype)
        if self.normalize_time:
            t = t / self.max_episode_steps
        return torch.cat([obs, t[:, None]], dim=-1)

    def init(self, rng, obs, carry, params=None):
        return None, self._with_time(obs, carry.steps)

    def update(self, wstate, ts, reset_mask, carry):
        return wstate, ts._replace(obs=self._with_time(ts.obs, carry.steps))

    def observation_space(self, space):
        high = self.max_episode_steps if self.max_episode_steps is not None else np.inf
        time_high = 1.0 if self.normalize_time else high
        return spaces.Box(
            np.concatenate([np.broadcast_to(space.low, space.shape), [0.0]]),
            np.concatenate([np.broadcast_to(space.high, space.shape), [time_high]]),
            dtype=space.dtype.name,
        )


class DelayObservationState(NamedTuple):
    buffer: torch.Tensor  # (N, delay + 1, *obs), most recent last
    count: torch.Tensor  # (N,) int32, observations seen this episode


class DelayObservation(FuncWrapper):
    """Emit each env's observation from ``delay`` steps earlier in its
    episode, zeros until then; the buffer restarts with the episode."""

    def __init__(self, delay: int):
        if delay < 1:
            raise ValueError(f"delay must be >= 1, got {delay}")
        self.delay = delay

    def _emit(self, buffer, count):
        oldest = buffer[:, 0]
        return torch.where(_lanes(count > self.delay, oldest), oldest, torch.zeros_like(oldest))

    def _fresh(self, obs):
        # the episode's first observation goes last
        return torch.stack([torch.zeros_like(obs)] * self.delay + [obs], dim=1)

    def init(self, rng, obs, carry, params=None):
        buffer = self._fresh(obs)
        count = torch.ones(obs.shape[0], dtype=torch.int32, device=obs.device)
        return DelayObservationState(buffer, count), self._emit(buffer, count)

    def update(self, wstate, ts, reset_mask, carry):
        obs = ts.obs
        pushed = torch.cat([wstate.buffer[:, 1:], obs[:, None]], dim=1)
        buffer = torch.where(_lanes(reset_mask, pushed), self._fresh(obs), pushed)
        count = torch.where(reset_mask, 1, wstate.count + 1).to(torch.int32)
        return DelayObservationState(buffer, count), ts._replace(obs=self._emit(buffer, count))


class StickyActionState(NamedTuple):
    rng: torch.Generator  # the batch's generator, which the repeat draws advance
    last_action: torch.Tensor  # (N, ...) the previously executed action
    is_first: torch.Tensor  # (N,) True right after an episode starts


class StickyAction(FuncWrapper):
    """Repeat the previously executed action with probability ``p``, never
    on an episode's first step (``repeat_action_duration=1``).

    A step's repeat draws are :meth:`draws` (U[0, 1), one a lane, from the
    generator in the state) and their map :meth:`apply`, so a test can feed
    the JAX wrapper's draws to the map.
    """

    def __init__(self, repeat_action_probability: float, action_space: Any = None):
        if not 0 <= repeat_action_probability < 1:
            raise ValueError(
                f"repeat_action_probability should be in [0, 1), got {repeat_action_probability}"
            )
        self.p = repeat_action_probability
        self._action_space = action_space

    def action_space(self, space):
        # the single-env action space, captured when the stack is assembled,
        # gives init the shape and dtype of the last-action buffer
        self._action_space = space
        return space

    def init(self, rng, obs, carry, params=None):
        if self._action_space is None:
            raise ValueError(
                "StickyAction needs the action space: pass action_space= or assemble it "
                "through TorchVectorEnv or make_train_step"
            )
        n, space = carry.prev_done.shape[0], self._action_space
        # integer actions are sampled as int32 (Space.sample_torch)
        dtype = torch.int32 if np.dtype(space.dtype).kind in "iu" else torch.float32
        last = torch.zeros((n,) + tuple(space.shape), dtype=dtype, device=obs.device)
        return StickyActionState(rng, last, torch.ones(n, dtype=torch.bool, device=obs.device)), obs

    def draws(self, wstate: StickyActionState, n: int) -> torch.Tensor:
        """The repeat draws of a step: U[0, 1) (n,)."""
        return torch.rand((n,), generator=wstate.rng, device=wstate.rng.device)

    def apply(self, wstate: StickyActionState, action, u):
        """The action executed for draws ``u``: the last one where ``u < p``
        on a lane past its episode's first step, else ``action``."""
        repeat = (u < self.p) & ~wstate.is_first
        last = wstate.last_action
        chosen = torch.where(_lanes(repeat, action), last, action.to(last.dtype))
        return wstate._replace(last_action=chosen), chosen

    def transform_action(self, wstate, action):
        return self.apply(wstate, action, self.draws(wstate, action.shape[0]))

    def update(self, wstate, ts, reset_mask, carry):
        # the step after a reset step is an episode's first real step
        return wstate._replace(is_first=reset_mask), ts


# ---------------------------------------------------------------------------
# Stateless transforms
# ---------------------------------------------------------------------------


class TransformObservation(FuncWrapper):
    """Apply ``fn(obs) -> obs``, a function of batched tensors."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def init(self, rng, obs, carry, params=None):
        return None, self.fn(obs)

    def update(self, wstate, ts, reset_mask, carry):
        return wstate, ts._replace(obs=self.fn(ts.obs))


class TransformAction(FuncWrapper):
    """Apply ``fn(action) -> action`` before the step."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def transform_action(self, wstate, action):
        return wstate, self.fn(action)


class TransformReward(FuncWrapper):
    """Apply ``fn(reward) -> reward``."""

    def __init__(self, fn: Callable[[Any], Any]):
        self.fn = fn

    def update(self, wstate, ts, reset_mask, carry):
        return wstate, ts._replace(reward=self.fn(ts.reward))


class _Bounds:
    """Float32 arrays as tensors, made once a device: a copy from the host
    on every step would wait for the device."""

    def __init__(self, *arrays):
        self.arrays = [np.asarray(a, np.float32) for a in arrays]
        self._on: dict = {}

    def on(self, device) -> list:
        tensors = self._on.get(device)
        if tensors is None:
            tensors = self._on[device] = [torch.as_tensor(a, device=device) for a in self.arrays]
        return tensors


class ClipAction(TransformAction):
    """Clip actions into ``[low, high]``."""

    def __init__(self, low, high):
        bounds = _Bounds(low, high)

        def clip(a):
            lo, hi = bounds.on(a.device)
            return torch.clamp(a, lo, hi)

        super().__init__(clip)


class ClipReward(TransformReward):
    """Clip rewards into ``[min_reward, max_reward]`` (either may be None)."""

    def __init__(self, min_reward: float | None = None, max_reward: float | None = None):
        super().__init__(lambda r: torch.clamp(r, min_reward, max_reward))


class RescaleAction(TransformAction):
    """Affinely map actions from ``[min_action, max_action]`` onto the env's
    ``[low, high]``, in float32: ``clip(low + scale * (a - min_action), low,
    high)`` with ``scale = (high - low) / (max_action - min_action)``."""

    def __init__(self, low, high, min_action=-1.0, max_action=1.0):
        low, high = np.asarray(low, np.float32), np.asarray(high, np.float32)
        min_a, max_a = np.float32(min_action), np.float32(max_action)
        bounds = _Bounds(low, high, min_a, (high - low) / (max_a - min_a))

        def rescale(a):
            lo, hi, lo_a, scale = bounds.on(a.device)
            return torch.clamp(lo + scale * (a - lo_a), lo, hi)

        super().__init__(rescale)


class RescaleObservation(TransformObservation):
    """Affinely map observations from ``[low, high]`` onto ``[min_obs,
    max_obs]``, in float32: ``min_obs + scale * (obs - low)`` with ``scale =
    (max_obs - min_obs) / (high - low)``."""

    def __init__(self, low, high, min_obs=-1.0, max_obs=1.0):
        low, high = np.asarray(low, np.float32), np.asarray(high, np.float32)
        min_o, max_o = np.float32(min_obs), np.float32(max_obs)
        bounds = _Bounds(min_o, (max_o - min_o) / (high - low), low)

        def rescale(o):
            lo_o, scale, lo = bounds.on(o.device)
            return lo_o + scale * (o - lo)

        super().__init__(rescale)


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


def episode_stats_to_infos(info: dict[str, Any]) -> dict[str, Any]:
    """Convert one step's fixed-shape episode info into the reference's vector
    info format: ``{"episode": {"r", "l"}, "_episode": mask}`` when at least
    one episode finished, else no episode keys. Reads the values back to the
    host.
    """
    mask = to_host(info["_episode"])
    passthrough = {
        k: v for k, v in info.items() if k not in ("episode_return", "episode_length", "_episode")
    }
    if not mask.any():
        return passthrough
    passthrough["episode"] = {
        "r": np.where(mask, to_host(info["episode_return"]), 0.0),
        "l": np.where(mask, to_host(info["episode_length"]), 0),
    }
    passthrough["_episode"] = mask
    return passthrough
