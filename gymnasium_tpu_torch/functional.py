"""Functional environment API: the compute core of the torch port.

Counterpart of the JAX package's ``functional.py``. Every environment is a
:class:`FuncEnv` whose hooks are functions of ``(state, action, rng,
params)``. Where the JAX hooks are written for one env and batched with
``vmap``, these hooks are batch-first: ``transition``, ``observation``,
``reward`` and ``terminal`` take and return tensors with a leading env axis,
and only ``initial`` needs to be told the batch size
(:func:`vectorize_func_env`). ``rng`` is a ``torch.Generator``; it is stateful,
so drawing from it advances it instead of splitting a key.

:func:`make_autoreset_step` folds next-step autoreset and time-limit
truncation into one step function that never branches on data, so no step
waits for the device.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, NamedTuple

import torch

__all__ = [
    "FuncEnv",
    "EnvCarry",
    "TimeStep",
    "make_autoreset_step",
    "make_initial_carry",
    "vectorize_func_env",
]


class FuncEnv:
    """A stateless environment: an MDP split into functions of tensors.

    Hooks (batch-first, ``rng`` a ``torch.Generator``):

    - ``initial(rng, params) -> state`` (one env; ``initial_batched(rng, n,
      params)`` draws a whole batch where the env provides it)
    - ``transition(state, action, rng, params) -> next_state``
    - ``observation(state, rng, params) -> obs``
    - ``reward(state, action, next_state, rng, params) -> reward``
    - ``terminal(state, rng, params) -> bool``
    """

    observation_space: Any
    action_space: Any

    def __init__(self, options: dict[str, Any] | None = None):
        self.__dict__.update(options or {})

    def initial(self, rng: torch.Generator, params: Any = None):
        """Generate an initial state from a generator."""
        raise NotImplementedError

    def transition(self, state, action, rng: torch.Generator, params: Any = None):
        """Advance the dynamics one step."""
        raise NotImplementedError

    def observation(self, state, rng: torch.Generator, params: Any = None):
        """Observation of ``state``."""
        raise NotImplementedError

    def reward(self, state, action, next_state, rng: torch.Generator, params: Any = None):
        """Reward of the ``state -> next_state`` transition."""
        raise NotImplementedError

    def terminal(self, state, rng: torch.Generator, params: Any = None):
        """Whether ``state`` is terminal."""
        raise NotImplementedError

    def get_default_params(self, **kwargs: Any) -> Any:
        """Default dynamics parameters."""
        return None


def vectorize_func_env(func_env: FuncEnv, num_envs: int) -> FuncEnv:
    """Return a FuncEnv whose ``initial`` draws a batch of ``num_envs`` states.

    The other hooks are batch-first already and are kept as they are. An env
    that provides ``initial_batched(rng, n, params)`` draws the batch in one
    call; otherwise ``initial`` is called once per env and stacked.
    """
    batched = copy.copy(func_env)
    initial_batched = getattr(func_env, "initial_batched", None)
    if initial_batched is not None:
        batched.initial = lambda rng, params=None: initial_batched(rng, num_envs, params)
    else:
        batched.initial = lambda rng, params=None: torch.stack(
            [func_env.initial(rng, params) for _ in range(num_envs)]
        )
    batched.num_envs = num_envs
    return batched


class EnvCarry(NamedTuple):
    """Carried state of an auto-resetting environment batch."""

    state: Any
    rng: torch.Generator
    steps: torch.Tensor
    prev_done: torch.Tensor


class TimeStep(NamedTuple):
    """Output of one auto-resetting step (all leaves batched)."""

    obs: Any
    reward: Any
    terminated: Any
    truncated: Any
    info: dict[str, Any]


def make_autoreset_step(
    func_env: FuncEnv,
    params: Any = None,
    time_limit: int | None = None,
    autoreset: bool = True,
) -> Callable[[EnvCarry, Any], tuple[EnvCarry, TimeStep]]:
    """Build a step with next-step autoreset folded in.

    The returned ``step(carry, action)`` never branches on data: a reset is
    drawn for the whole batch every step and selected with ``torch.where``.
    The step *after* a done returns the reset observation with reward 0 and
    both flags False, ignoring the submitted action, and its step counter
    restarts at 0. Truncation is ``steps >= time_limit`` on a lane that did
    not terminate; ``time_limit=None`` disables it.
    """

    def step(carry: EnvCarry, action: Any) -> tuple[EnvCarry, TimeStep]:
        rng = carry.rng
        next_state = func_env.transition(carry.state, action, rng, params)
        if autoreset:
            reset_state = func_env.initial(rng, params)
            prev_done = carry.prev_done
            lane = prev_done.reshape(prev_done.shape + (1,) * (next_state.ndim - prev_done.ndim))
            state = torch.where(lane, reset_state, next_state)
            # the reset step performs no transition: the new episode starts at 0
            steps = torch.where(prev_done, 0, carry.steps + 1)
        else:
            state = next_state
            steps = carry.steps + 1
            prev_done = torch.zeros_like(carry.prev_done)

        obs = func_env.observation(state, rng, params)
        raw_reward = func_env.reward(carry.state, action, state, rng, params)
        raw_terminated = func_env.terminal(state, rng, params)

        if autoreset:
            reward = torch.where(prev_done, 0.0, raw_reward)
            terminated = raw_terminated & ~prev_done
        else:
            reward = raw_reward
            terminated = raw_terminated

        if time_limit is not None:
            truncated = ~terminated & (steps >= time_limit)
            if autoreset:
                truncated = truncated & ~prev_done
        else:
            truncated = torch.zeros_like(terminated)

        done = terminated | truncated
        new_carry = EnvCarry(state=state, rng=rng, steps=steps, prev_done=done)
        return new_carry, TimeStep(obs, reward, terminated, truncated, {})

    return step


def make_initial_carry(
    func_env: FuncEnv, rng: torch.Generator, params: Any = None
) -> tuple[EnvCarry, Any]:
    """Initial ``(carry, obs)`` drawn from ``rng``."""
    state = func_env.initial(rng, params)
    obs = func_env.observation(state, rng, params)
    term_proto = func_env.terminal(state, rng, params)
    steps = torch.zeros(term_proto.shape, dtype=torch.int32, device=term_proto.device)
    prev_done = torch.zeros(term_proto.shape, dtype=torch.bool, device=term_proto.device)
    return EnvCarry(state=state, rng=rng, steps=steps, prev_done=prev_done), obs
