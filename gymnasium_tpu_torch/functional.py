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
waits for the device. A state may be one tensor or a tree of them (dicts,
tuples and lists), as a JAX pytree is; :func:`tree_map` walks it.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy
from typing import Any, Callable, Iterator, NamedTuple

import torch

from gymnasium_tpu_torch.utils.tracing import span

__all__ = [
    "FuncEnv",
    "EnvCarry",
    "TimeStep",
    "deferred_ticks",
    "make_autoreset_step",
    "make_initial_carry",
    "select_lanes",
    "ticks_deferred",
    "tree_map",
    "vectorize_func_env",
]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply ``fn`` leaf by leaf over trees of one structure.

    Dicts, tuples (named ones too) and lists are nodes; anything else is a
    leaf. ``fn`` takes one leaf of ``tree`` and the matching leaf of each of
    ``rest``.
    """
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        children = [tree_map(fn, *leaves) for leaves in zip(tree, *rest)]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return type(tree)(children)
    return fn(tree, *rest)


def _lanes(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """``mask`` (the env axis) shaped to broadcast over ``leaf``."""
    return mask.reshape(mask.shape + (1,) * (leaf.ndim - mask.ndim))


def select_lanes(mask: torch.Tensor, on: Any, off: Any) -> Any:
    """Lane by lane, the leaves of ``on`` where ``mask`` is set and those of
    ``off`` elsewhere. Each leaf of ``off`` is a tensor with the env axis
    first; a leaf of ``on`` may be a python number."""
    return tree_map(lambda a, b: torch.where(_lanes(mask, b), a, b), on, off)


_DEFERRED: contextvars.ContextVar[bool] = contextvars.ContextVar("deferred_ticks", default=False)


@contextlib.contextmanager
def deferred_ticks() -> Iterator[None]:
    """Inside the block, an env whose transition and reset each end in one
    solver call returns that call's inputs instead of making it (see
    ``FuncEnv.autoreset_transition``)."""
    token = _DEFERRED.set(True)
    try:
        yield
    finally:
        _DEFERRED.reset(token)


def ticks_deferred() -> bool:
    """Whether a :func:`deferred_ticks` block is open."""
    return _DEFERRED.get()


class FuncEnv:
    """A stateless environment: an MDP split into functions of tensors.

    Hooks (batch-first, ``rng`` a ``torch.Generator``):

    - ``initial(rng, params) -> state`` (one env; ``initial_batched(rng, n,
      params)`` draws a whole batch where the env provides it)
    - ``transition(state, action, rng, params) -> next_state``
    - ``observation(state, rng, params) -> obs``
    - ``reward(state, action, next_state, rng, params) -> reward``
    - ``terminal(state, rng, params) -> bool``

    ``state_info``/``transition_info`` give the single-env adapter's info
    dicts; ``render_init``/``render_image``/``render_close`` raise until an
    env brings a renderer.

    An env may also provide ``autoreset_transition(state, action, prev_done,
    rng, params) -> state``: the state each lane of a batch holds after an
    autoreset step, the transition of ``state`` under ``action`` where
    ``prev_done`` is False and the reset where it is True, with the same
    draws in the same order and the same bits as ``transition`` followed by
    the batch's ``initial``. :func:`make_autoreset_step` calls it when it is
    set; the Box2D-class envs use it to make one solver call a step.
    """

    observation_space: Any
    action_space: Any
    autoreset_transition: Callable | None = None

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

    # -- info hooks --------------------------------------------------------

    def state_info(self, state, params: Any = None) -> dict[str, Any]:
        """Info dict for an initial state."""
        return {}

    def transition_info(self, state, action, next_state, params: Any = None) -> dict[str, Any]:
        """Info dict for a transition."""
        return {}

    def get_default_params(self, **kwargs: Any) -> Any:
        """Default dynamics parameters."""
        return None

    # -- transformation ----------------------------------------------------

    def transform(self, func: Callable[[Callable], Callable]) -> None:
        """Rebind every hook through ``func`` in place (e.g. ``torch.compile``),
        as the JAX package's ``FuncEnv.transform`` does with ``jax.jit``."""
        self.initial = func(self.initial)  # type: ignore[method-assign]
        self.transition = func(self.transition)  # type: ignore[method-assign]
        self.observation = func(self.observation)  # type: ignore[method-assign]
        self.reward = func(self.reward)  # type: ignore[method-assign]
        self.terminal = func(self.terminal)  # type: ignore[method-assign]

    # -- rendering ---------------------------------------------------------

    def render_image(self, state, render_state, params: Any = None):
        """Render ``state`` into ``(render_state, image)``."""
        raise NotImplementedError

    def render_init(self, **kwargs: Any):
        """Initialise the host-side render state."""
        raise NotImplementedError

    def render_close(self, render_state) -> None:
        """Close the host-side render state."""
        raise NotImplementedError


def vectorize_func_env(func_env: FuncEnv, num_envs: int, sharding: Any = None) -> FuncEnv:
    """Return a FuncEnv whose ``initial`` draws a batch of ``num_envs`` states.

    The other hooks are batch-first already and are kept as they are. An env
    that provides ``initial_batched(rng, n, params)`` draws the batch in one
    call; otherwise ``initial`` is called once per env and stacked.

    ``sharding`` (a :class:`~gymnasium_tpu_torch.parallel.mesh.NamedSharding`
    over the env axis, or None) makes the hooks work on this rank's rows of
    the ``num_envs`` batch, as the JAX function forwards it to the batched
    kernel factories for ``shard_map``: ``initial`` returns those rows, and
    ``reset_draws`` and ``transition_draws`` draw for the whole batch and
    keep them, so each rank's rows are the unsharded batch's rows. An env
    without ``reset_draws`` and ``initial_batched`` draws its whole batch
    and keeps the rows; a ``transition`` without ``transition_draws`` must
    draw nothing. The kernels need no factory: each launches on whatever
    batch it is given.
    """
    batched = copy.copy(func_env)
    initial_batched = getattr(func_env, "initial_batched", None)
    n = num_envs
    if sharding is not None:
        from gymnasium_tpu_torch.parallel.mesh import shard_for

        shard = shard_for(sharding)
        for hook in ("reset_draws", "transition_draws"):
            draws = getattr(func_env, hook, None)
            if draws is not None:
                setattr(batched, hook, lambda rng, k, draws=draws: tree_map(
                    lambda d: None if d is None else shard.take(d), draws(rng, k * shard.count)))
        if initial_batched is not None and hasattr(func_env, "reset_draws"):
            # bound to the copy, whose reset_draws keeps this rank's rows
            initial_batched, n = batched.initial_batched, shard.local_count(num_envs)
        else:
            whole = vectorize_func_env(func_env, num_envs)
            batched.initial = lambda rng, params=None: tree_map(shard.take, whole.initial(rng, params))
            batched.num_envs = num_envs
            return batched
    if initial_batched is not None:
        batched.initial = lambda rng, params=None: initial_batched(rng, n, params)
    else:
        batched.initial = lambda rng, params=None: tree_map(
            lambda *leaves: torch.stack(leaves),
            *[func_env.initial(rng, params) for _ in range(n)],
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
    drawn for the whole batch every step and selected with ``torch.where``
    (inside the env's ``autoreset_transition`` where it has one).
    The step *after* a done returns the reset observation with reward 0 and
    both flags False, ignoring the submitted action, and its step counter
    restarts at 0. Truncation is ``steps >= time_limit`` on a lane that did
    not terminate; ``time_limit=None`` disables it.
    """

    fused = getattr(func_env, "autoreset_transition", None) if autoreset else None

    def step(carry: EnvCarry, action: Any) -> tuple[EnvCarry, TimeStep]:
        rng = carry.rng
        if autoreset:
            prev_done = carry.prev_done
            if fused is not None:
                with span("func.transition"):
                    state = fused(carry.state, action, prev_done, rng, params)
            else:
                with span("func.transition"):
                    next_state = func_env.transition(carry.state, action, rng, params)
                with span("func.reset"):
                    state = select_lanes(prev_done, func_env.initial(rng, params), next_state)
            # the reset step performs no transition: the new episode starts at 0
            steps = torch.where(prev_done, 0, carry.steps + 1)
        else:
            with span("func.transition"):
                state = func_env.transition(carry.state, action, rng, params)
            steps = carry.steps + 1
            prev_done = torch.zeros_like(carry.prev_done)

        with span("func.observation"):
            obs = func_env.observation(state, rng, params)
        with span("func.reward"):
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
