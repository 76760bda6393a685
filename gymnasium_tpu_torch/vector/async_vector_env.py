"""AsyncVectorEnv: process-parallel host-side vectorization (copy of the JAX
package's ``vector/async_vector_env.py``).

It behaves as Gymnasium's (gymnasium/vector/async_vector_env.py:54-859):
public API, AsyncState guard semantics, autoreset modes, shared-memory
transport, crash propagation, close escalation. The internals are the JAX
package's: a per-sub-env :class:`_Peer` handle owning the pipe/process pair,
a single phase guard (`_arm`/`_collect`) shared by every split-phase call,
and a worker built from a command dispatch table with the autoreset policy
chosen once at startup instead of branched per step.

Sub-envs on the card: a worker that steps a card env opens its own CUDA
context, which a process forked from a parent that has used CUDA cannot do.
Build such envs with ``context="spawn"`` (or ``"forkserver"``), e.g.
``make_vec(id, n, vectorization_mode="async", vector_kwargs={"context":
"spawn"})``. Under ``spawn`` every env factory is pickled; ``make_vec``'s
factory is a module-level object, so the standard library pickles it. A
worker whose env cannot be built reports the error to the parent, which
raises it.
"""

from __future__ import annotations

import multiprocessing
import sys
import time
import traceback
from copy import deepcopy
from enum import Enum
from typing import Any, Callable, Sequence

import numpy as np

from gymnasium_tpu_torch import Env, logger
from gymnasium_tpu_torch.error import (
    AlreadyPendingCallError,
    ClosedEnvironmentError,
    CustomSpaceError,
    NoAsyncCallError,
)
from gymnasium_tpu_torch.spaces.utils import is_space_dtype_shape_equiv
from gymnasium_tpu_torch.vector.utils import (
    CloudpickleWrapper,
    batch_differing_spaces,
    batch_space,
    clear_mpi_env_vars,
    concatenate,
    create_empty_array,
    create_shared_memory,
    iterate,
    read_from_shared_memory,
    write_to_shared_memory,
)
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv

__all__ = ["AsyncVectorEnv", "AsyncState"]


class AsyncState(Enum):
    """Which split-phase call (if any) is outstanding."""

    DEFAULT = "default"
    WAITING_RESET = "reset"
    WAITING_STEP = "step"
    WAITING_CALL = "call"


class _Peer:
    """Parent-side handle for one worker: pipe + process + liveness."""

    def __init__(self, index: int, process, pipe):
        self.index = index
        self.process = process
        self.pipe = pipe

    def post(self, command: str, payload: Any = None) -> None:
        self.pipe.send((command, payload))

    def fetch(self) -> tuple[Any, bool]:
        """One ``(result, ok)`` reply."""
        return self.pipe.recv()

    def readable_by(self, deadline: float | None) -> bool:
        """Whether a reply arrives before ``deadline`` (None = block)."""
        if self.pipe is None or self.pipe.closed:
            return False
        if deadline is None:
            return True
        return self.pipe.poll(max(deadline - time.perf_counter(), 0))

    def drop(self) -> None:
        """Close the pipe and forget it (worker died or was shut down)."""
        if self.pipe is not None:
            self.pipe.close()
            self.pipe = None


class AsyncVectorEnv(VectorEnv):
    """Batched env running each sub-env in its own OS process."""

    def __init__(
        self,
        env_fns: Sequence[Callable[[], Env]],
        shared_memory: bool = True,
        copy: bool = True,
        context: str | None = None,
        daemon: bool = True,
        worker: Callable | None = None,
        observation_mode: str | Any = "same",
        autoreset_mode: str | AutoresetMode = AutoresetMode.NEXT_STEP,
    ):
        self.env_fns = env_fns
        self.num_envs = len(env_fns)
        self.shared_memory = shared_memory
        self.copy = copy
        self.context = context
        self.daemon = daemon
        self.worker = worker
        self.observation_mode = observation_mode
        self.autoreset_mode = (
            AutoresetMode(autoreset_mode)
            if isinstance(autoreset_mode, str)
            else autoreset_mode
        )
        assert isinstance(self.autoreset_mode, AutoresetMode)

        self._resolve_spaces_and_metadata()

        ctx = multiprocessing.get_context(context)
        self._shm = self._allocate_observation_buffers(ctx)
        self.error_queue = ctx.Queue()
        self._peers: list[_Peer | None] = []
        self._spawn_workers(ctx)

        self._pending = AsyncState.DEFAULT
        try:
            self._validate_worker_spaces()
        except BaseException:
            # a worker that failed to build its env (or a space mismatch)
            # must not leave the others running behind an env nobody holds
            self.close(terminate=True)
            raise

    # -- construction helpers ----------------------------------------------

    def _resolve_spaces_and_metadata(self) -> None:
        """Instantiate one throwaway env for metadata + spaces; in
        ``observation_mode='different'`` sample every env's space."""
        probe = self.env_fns[0]()
        # a copy: the probe's metadata is its class's dict, which the
        # autoreset mode written below must not reach
        self.metadata = deepcopy(probe.metadata)
        self.metadata["autoreset_mode"] = self.autoreset_mode
        self.render_mode = probe.render_mode

        self.single_action_space = probe.action_space
        self.action_space = batch_space(self.single_action_space, self.num_envs)

        mode = self.observation_mode
        if isinstance(mode, tuple) and len(mode) == 2:
            # caller supplies (batched, single) spaces directly
            self.observation_space, self.single_observation_space = mode
        elif mode == "same":
            self.single_observation_space = probe.observation_space
            self.observation_space = batch_space(
                self.single_observation_space, self.num_envs
            )
        elif mode == "different":
            per_env = [fn().observation_space for fn in self.env_fns]
            self.single_observation_space = per_env[0]
            self.observation_space = batch_differing_spaces(per_env)
        else:
            raise ValueError(
                f"Invalid `observation_mode`, expected: 'same' or 'different' or tuple of single and batch observation space, actual got {mode}"
            )
        probe.close()

    def _allocate_observation_buffers(self, ctx):
        """Shared-memory blocks (workers write, parent views zero-copy) or a
        plain preallocated batch array filled from pickled replies."""
        if self.shared_memory:
            try:
                shm = create_shared_memory(
                    self.single_observation_space, n=self.num_envs, ctx=ctx
                )
            except CustomSpaceError as e:
                raise ValueError(
                    "Using `shared_memory=True` in `AsyncVectorEnv` is incompatible with non-standard spaces "
                    "(i.e. custom spaces inheriting from `gymnasium_tpu_torch.Space`), and is only compatible with default Gymnasium spaces "
                    "(e.g. `Box`, `Tuple`, `Dict`) for batching. Set `shared_memory=False` if you use custom spaces."
                ) from e
            self.observations = read_from_shared_memory(
                self.single_observation_space, shm, n=self.num_envs
            )
            return shm
        self.observations = create_empty_array(
            self.single_observation_space, n=self.num_envs, fn=np.zeros
        )
        return None

    def _spawn_workers(self, ctx) -> None:
        entry = self.worker if self.worker is not None else _worker_main
        with clear_mpi_env_vars():
            for index, env_fn in enumerate(self.env_fns):
                ours, theirs = ctx.Pipe()
                proc = ctx.Process(
                    target=entry,
                    name=f"Worker<{type(self).__name__}>-{index}",
                    args=(
                        index,
                        CloudpickleWrapper(env_fn),
                        theirs,
                        ours,
                        self._shm,
                        self.error_queue,
                        self.autoreset_mode,
                    ),
                )
                proc.daemon = self.daemon
                proc.start()
                theirs.close()
                self._peers.append(_Peer(index, proc, ours))

    def _validate_worker_spaces(self) -> None:
        payload = (
            self.observation_mode,
            self.single_observation_space,
            self.single_action_space,
        )
        self._arm(AsyncState.WAITING_CALL, "_check_spaces")
        self._broadcast("_check_spaces", payload)
        results = self._collect(AsyncState.WAITING_CALL, "_check_spaces", None)
        obs_ok, act_ok = zip(*results)
        if not all(obs_ok):
            if self.observation_mode == "same":
                raise RuntimeError(
                    "AsyncVectorEnv(..., observation_mode='same') however some of the sub-environments observation spaces are not equivalent. "
                    "If this is intentional, use `observation_mode='different'` instead."
                )
            raise RuntimeError(
                "AsyncVectorEnv(..., observation_mode='different') however the sub-environment observation spaces do not share a common shape and dtype."
            )
        if not all(act_ok):
            raise RuntimeError(
                f"Some environments have an action space different from `{self.single_action_space}`. "
                "In order to batch actions, the action spaces from all environments must be equal."
            )

    # -- phase guard (shared by every split-phase call) --------------------

    def _ensure_open(self) -> None:
        if self.closed:
            raise ClosedEnvironmentError(
                f"Trying to operate on `{type(self).__name__}`, after a call to `close()`."
            )

    def _arm(self, phase: AsyncState, op: str) -> None:
        """Enter ``phase``; reject when another call is already pending."""
        self._ensure_open()
        if self._pending != AsyncState.DEFAULT:
            raise AlreadyPendingCallError(
                f"Calling `{op}` while waiting for a pending call to `{self._pending.value}` to complete.",
                str(self._pending.value),
            )
        self._pending = phase

    def _collect(
        self, phase: AsyncState, op: str, timeout: int | float | None
    ) -> list[Any]:
        """Gather one reply per worker for the armed ``phase``.

        Raises ``multiprocessing.TimeoutError`` (phase cleared) if any worker
        misses the deadline; surfaces worker exceptions; returns the
        successful results in env order.
        """
        self._ensure_open()
        if self._pending != phase:
            raise NoAsyncCallError(
                f"Calling `{op}_wait` without any prior call to `{op}_async`.",
                phase.value,
            )

        self._ensure_no_dead_workers(op)
        deadline = None if timeout is None else time.perf_counter() + timeout
        if not all(p.readable_by(deadline) for p in self._peers):
            self._pending = AsyncState.DEFAULT
            raise multiprocessing.TimeoutError(
                f"The call to `{op}_wait` has timed out after {timeout} second(s)."
            )

        replies = [peer.fetch() for peer in self._peers]
        self._surface_worker_errors([ok for _, ok in replies])
        self._pending = AsyncState.DEFAULT
        return [result for result, ok in replies if ok]

    def _ensure_no_dead_workers(self, op: str) -> None:
        dead = [i for i, peer in enumerate(self._peers) if peer is None]
        if dead:
            self._pending = AsyncState.DEFAULT
            raise ClosedEnvironmentError(
                f"Cannot `{op}`: worker(s) {dead} previously died with an error "
                "and were shut down. Recreate the AsyncVectorEnv to continue."
            )

    def _broadcast(self, command: str, payloads: Any = None, per_env: bool = False):
        self._ensure_no_dead_workers(command)
        if per_env:
            for peer, payload in zip(self._peers, payloads):
                peer.post(command, payload)
        else:
            for peer in self._peers:
                peer.post(command, payloads)

    def _surface_worker_errors(self, oks: Sequence[bool]) -> None:
        failures = len(oks) - sum(oks)
        if failures == 0:
            return
        last_exc: BaseException | None = None
        for _ in range(failures):
            index, exctype, value, trace = self.error_queue.get()
            logger.error(
                f"Received the following error from Worker-{index} - Shutting it down"
            )
            logger.error(f"{trace}")
            self._peers[index].drop()
            self._peers[index] = None
            last_exc = exctype(value)
        logger.error("Raising the last exception back to the main process.")
        self._pending = AsyncState.DEFAULT
        raise last_exc

    # -- reset -------------------------------------------------------------

    def reset(
        self,
        *,
        seed: int | list[int | None] | None = None,
        options: dict[str, Any] | None = None,
    ):
        """Reset all sub-environments (split-phase under the hood)."""
        self.reset_async(seed=seed, options=options)
        return self.reset_wait()

    def reset_async(
        self,
        seed: int | list[int | None] | None = None,
        options: dict[str, Any] | None = None,
    ):
        """Send reset commands to the workers."""
        self._ensure_open()
        if seed is None:
            seeds: list[int | None] = [None] * self.num_envs
        elif isinstance(seed, int):
            seeds = [seed + i for i in range(self.num_envs)]
        else:
            seeds = list(seed)
        assert len(seeds) == self.num_envs, (
            f"If seeds are passed as a list the length must match num_envs={self.num_envs} but got length={len(seeds)}."
        )

        mask = np.ones(self.num_envs, dtype=np.bool_)
        if options is not None and "reset_mask" in options:
            mask = options.pop("reset_mask")
            assert isinstance(mask, np.ndarray), (
                f"`options['reset_mask': mask]` must be a numpy array, got {type(mask)}"
            )
            assert mask.shape == (self.num_envs,), (
                f"`options['reset_mask': mask]` must have shape `({self.num_envs},)`, got {mask.shape}"
            )
            assert mask.dtype == np.bool_, (
                f"`options['reset_mask': mask]` must have `dtype=np.bool_`, got {mask.dtype}"
            )
            assert np.any(mask), (
                f"`options['reset_mask': mask]` must contain a boolean array, got reset_mask={mask}"
            )

        self._arm(AsyncState.WAITING_RESET, "reset_async")
        for peer, env_seed, do_reset in zip(self._peers, seeds, mask):
            if do_reset:
                peer.post("reset", {"seed": env_seed, "options": options})
            else:
                peer.post("reset-noop")

    def reset_wait(self, timeout: int | float | None = None):
        """Collect reset results from the workers."""
        results = self._collect(AsyncState.WAITING_RESET, "reset", timeout)

        infos: dict[str, Any] = {}
        obs_parts = []
        for env_idx, (obs, info) in enumerate(results):
            obs_parts.append(obs)
            infos = self._add_info(infos, info, env_idx)

        if not self.shared_memory:
            self.observations = concatenate(
                self.single_observation_space, obs_parts, self.observations
            )
        return (
            deepcopy(self.observations) if self.copy else self.observations
        ), infos

    # -- step --------------------------------------------------------------

    def step(self, actions):
        """Step all sub-environments (split-phase under the hood)."""
        self.step_async(actions)
        return self.step_wait()

    def step_async(self, actions: np.ndarray):
        """Send actions to the workers."""
        self._arm(AsyncState.WAITING_STEP, "step_async")
        # strict: a mismatched action count must raise before anything is
        # sent, not silently truncate against the worker list
        try:
            per_env_actions = list(iterate(self.action_space, actions))
            if len(per_env_actions) != self.num_envs:
                raise ValueError(
                    f"Expected {self.num_envs} actions, got {len(per_env_actions)}"
                )
        except Exception:
            self._pending = AsyncState.DEFAULT
            raise
        self._broadcast("step", per_env_actions, per_env=True)

    def step_wait(self, timeout: int | float | None = None):
        """Collect step results from the workers."""
        results = self._collect(AsyncState.WAITING_STEP, "step", timeout)

        infos: dict[str, Any] = {}
        obs_parts, rewards, terminations, truncations = [], [], [], []
        for env_idx, (obs, reward, terminated, truncated, info) in enumerate(results):
            obs_parts.append(obs)
            rewards.append(reward)
            terminations.append(terminated)
            truncations.append(truncated)
            infos = self._add_info(infos, info, env_idx)

        if not self.shared_memory:
            self.observations = concatenate(
                self.single_observation_space, obs_parts, self.observations
            )
        return (
            deepcopy(self.observations) if self.copy else self.observations,
            np.array(rewards, dtype=np.float64),
            np.array(terminations, dtype=np.bool_),
            np.array(truncations, dtype=np.bool_),
            infos,
        )

    # -- call / get / set --------------------------------------------------

    def call(self, name: str, *args: Any, **kwargs: Any) -> tuple[Any, ...]:
        """Call a method on every sub-env and return the results."""
        self.call_async(name, *args, **kwargs)
        return self.call_wait()

    def render(self) -> tuple | None:
        return self.call("render")

    def call_async(self, name: str, *args, **kwargs):
        """Send a method-call command to the workers."""
        self._arm(AsyncState.WAITING_CALL, "call_async")
        self._broadcast("_call", (name, args, kwargs))

    def call_wait(self, timeout: int | float | None = None) -> tuple[Any, ...]:
        """Collect method-call results from the workers."""
        return tuple(self._collect(AsyncState.WAITING_CALL, "call", timeout))

    def get_attr(self, name: str) -> tuple[Any, ...]:
        """Read attribute ``name`` from every sub-env."""
        return self.call(name)

    def set_attr(self, name: str, values: list[Any] | tuple[Any] | object):
        """Set attribute ``name`` on every sub-env (synchronous)."""
        self._ensure_open()
        if not isinstance(values, (list, tuple)):
            values = [values] * self.num_envs
        if len(values) != self.num_envs:
            raise ValueError(
                "Values must be a list or tuple with length equal to the number of environments. "
                f"Got `{len(values)}` values for {self.num_envs} environments."
            )
        if self._pending != AsyncState.DEFAULT:
            raise AlreadyPendingCallError(
                f"Calling `set_attr` while waiting for a pending call to `{self._pending.value}` to complete.",
                str(self._pending.value),
            )
        self._broadcast("_setattr", [(name, v) for v in values], per_env=True)
        replies = [peer.fetch() for peer in self._peers]
        self._surface_worker_errors([ok for _, ok in replies])

    @property
    def processes(self) -> list:
        """Worker process handles (reference-compatible accessor)."""
        return [peer.process for peer in self._peers if peer is not None]

    @property
    def parent_pipes(self) -> list:
        """Parent ends of the worker pipes (reference-compatible accessor)."""
        return [None if peer is None else peer.pipe for peer in self._peers]

    @property
    def np_random_seed(self) -> tuple[int, ...]:
        """Seeds of all sub-environments."""
        return self.get_attr("np_random_seed")

    @property
    def np_random(self) -> tuple[np.random.Generator, ...]:
        """Generators of all sub-environments."""
        return self.get_attr("np_random")

    # -- shutdown ----------------------------------------------------------

    def close_extras(self, timeout: int | float | None = None, terminate: bool = False):
        """Shut down the worker processes; escalate to terminate on timeout."""
        timeout = 0 if terminate else timeout
        try:
            if self._pending != AsyncState.DEFAULT:
                logger.warn(
                    f"Calling `close` while waiting for a pending call to `{self._pending.value}` to complete."
                )
                drain = getattr(self, f"{self._pending.value}_wait")
                drain(timeout)
        except multiprocessing.TimeoutError:
            terminate = True

        if terminate:
            for peer in self._peers:
                if peer is not None and peer.process.is_alive():
                    peer.process.terminate()
        else:
            for peer in self._peers:
                if peer is not None and peer.pipe is not None and not peer.pipe.closed:
                    peer.post("close")
            for peer in self._peers:
                if peer is not None and peer.pipe is not None and not peer.pipe.closed:
                    peer.fetch()

        for peer in self._peers:
            if peer is not None:
                peer.drop()
                peer.process.join()

    def __del__(self):
        if not getattr(self, "closed", True) and hasattr(self, "_pending"):
            self.close(terminate=True)


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------


def _stepper_for(mode: AutoresetMode, env: Env):
    """Select the per-mode step policy ONCE at worker startup.

    Each policy is ``step(action, needs_reset) -> (result5, needs_reset)``
    where ``result5 = (obs, reward, terminated, truncated, info)``.
    """
    if mode == AutoresetMode.NEXT_STEP:

        def step(action, needs_reset):
            # the step after a done ignores the action and resets
            if needs_reset:
                obs, info = env.reset()
                return (obs, 0.0, False, False, info), False
            obs, reward, terminated, truncated, info = env.step(action)
            return (obs, reward, terminated, truncated, info), bool(
                terminated or truncated
            )

    elif mode == AutoresetMode.SAME_STEP:

        def step(action, needs_reset):
            obs, reward, terminated, truncated, info = env.step(action)
            if terminated or truncated:
                final_obs, final_info = obs, info
                obs, reset_info = env.reset()
                info = {
                    "final_info": final_info,
                    "final_obs": final_obs,
                    **reset_info,
                }
            return (obs, reward, terminated, truncated, info), False

    elif mode == AutoresetMode.DISABLED:

        def step(action, needs_reset):
            assert needs_reset is False
            return env.step(action), False

    else:
        raise ValueError(f"Unexpected autoreset_mode: {mode}")

    return step


def _worker_main(
    index: int,
    env_fn: Callable,
    pipe,
    parent_pipe,
    shared_memory: Any,
    error_queue,
    autoreset_mode: AutoresetMode,
):
    """Child-process entry: a dispatch-table command loop around one env."""
    parent_pipe.close()
    env = step_policy = None
    # mutable per-episode slot shared by the handlers
    slot = {"needs_reset": False, "last_obs": None}

    def publish(obs):
        """Route the observation: into shared memory (reply None) or back
        through the pipe."""
        if shared_memory:
            write_to_shared_memory(env.observation_space, index, obs, shared_memory)
            return None
        return obs

    def on_reset(payload):
        obs, info = env.reset(**payload)
        slot["needs_reset"] = False
        slot["last_obs"] = publish(obs)
        return (slot["last_obs"], info)

    def on_reset_noop(payload):
        return (slot["last_obs"], {})

    def on_step(action):
        result, slot["needs_reset"] = step_policy(action, slot["needs_reset"])
        obs, reward, terminated, truncated, info = result
        slot["last_obs"] = publish(obs)
        return (slot["last_obs"], reward, terminated, truncated, info)

    def on_call(payload):
        name, args, kwargs = payload
        if name in ("reset", "step", "close", "_setattr", "_check_spaces"):
            raise ValueError(
                f"Trying to call function `{name}` with `call`, use `{name}` directly instead."
            )
        attr = env.get_wrapper_attr(name)
        return attr(*args, **kwargs) if callable(attr) else attr

    def on_setattr(payload):
        name, value = payload
        env.set_wrapper_attr(name, value)
        return None

    def on_check_spaces(payload):
        obs_mode, single_obs_space, single_act_space = payload
        obs_ok = (
            single_obs_space == env.observation_space
            if obs_mode == "same"
            else is_space_dtype_shape_equiv(single_obs_space, env.observation_space)
        )
        return (obs_ok, single_act_space == env.action_space)

    handlers = {
        "reset": on_reset,
        "reset-noop": on_reset_noop,
        "step": on_step,
        "_call": on_call,
        "_setattr": on_setattr,
        "_check_spaces": on_check_spaces,
    }

    try:
        # a failure to build the env (CUDA in a forked child, for one)
        # reaches the parent as any other error of this worker does
        env = env_fn()
        step_policy = _stepper_for(autoreset_mode, env)
        while True:
            command, payload = pipe.recv()
            if command == "close":
                pipe.send((None, True))
                break
            handler = handlers.get(command)
            if handler is None:
                raise RuntimeError(
                    f"Received unknown command `{command}`. Must be one of [`reset`, `step`, `close`, `_call`, `_setattr`, `_check_spaces`]."
                )
            pipe.send((handler(payload), True))
    except (KeyboardInterrupt, Exception):
        exc_type, exc_value, _ = sys.exc_info()
        error_queue.put((index, exc_type, exc_value, traceback.format_exc()))
        pipe.send((None, False))
    finally:
        if env is not None:
            env.close()
