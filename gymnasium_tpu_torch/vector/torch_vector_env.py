"""Device-resident vector env over a batch-first :class:`FuncEnv`.

Counterpart of the JAX package's ``vector/jax_vector_env.py::JaxVectorEnv``.
The whole batch lives on one device; ``step`` is the auto-resetting step of
:func:`~gymnasium_tpu_torch.functional.make_autoreset_step`, with a stack of
functional wrappers (:mod:`gymnasium_tpu_torch.wrappers.func`) folded in when
one is given, and ``rollout`` runs it in a plain Python loop where the JAX
class compiles a ``lax.scan``. No step reads a value back to the host.

With ``sharding`` (a :class:`~gymnasium_tpu_torch.parallel.mesh.NamedSharding`
over the env axis) the carry is placed as the JAX class's ``_place`` places
it: per-env leaves are DTensors sharded over the mesh, the rest replicate.
Every rank of the mesh builds the env and calls each method in step; each
steps its own rows with the same step function, draws its rows of the whole
batch's draws, and returns DTensors. A sharded carry assigned to an env
built without ``sharding`` is stepped the same way.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from gymnasium_tpu_torch.functional import (
    EnvCarry,
    FuncEnv,
    TimeStep,
    make_autoreset_step,
    make_initial_carry,
    tree_map,
    vectorize_func_env,
)
from gymnasium_tpu_torch.parallel.shard import use as use_shard
from gymnasium_tpu_torch.utils.device import resolve_device
from gymnasium_tpu_torch.utils.tracing import span
from gymnasium_tpu_torch.vector.utils import batch_space
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv
from gymnasium_tpu_torch.wrappers.func import (
    FuncWrapper,
    WrappedEnvCarry,
    per_env_mask,
    wrap_autoreset_step,
    wrap_initial,
    wrapped_spaces,
)

__all__ = ["TorchVectorEnv"]


class TorchVectorEnv(VectorEnv):
    """Batched auto-resetting env whose state stays on ``device`` (CUDA by default).

    ``wrappers`` is a stack of functional wrappers, innermost first. With
    one, ``carry`` is a :class:`WrappedEnvCarry` and the wrapper states
    thread through every step. ``sharding`` places the batch over a mesh
    (module docstring).
    """

    metadata: dict[str, Any] = {"autoreset_mode": AutoresetMode.NEXT_STEP, "torch": True}

    def __init__(
        self,
        func_env: FuncEnv,
        num_envs: int,
        params: Any = None,
        max_episode_steps: int | None = None,
        autoreset_mode: AutoresetMode = AutoresetMode.NEXT_STEP,
        seed: int | None = None,
        device: str | torch.device | None = None,
        sharding: Any = None,
        wrappers: Any = None,
    ):
        self.wrappers = tuple(wrappers) if wrappers else ()
        for w in self.wrappers:
            if not isinstance(w, FuncWrapper):
                raise TypeError(f"wrappers must be FuncWrapper instances, got {type(w).__name__}")
        if autoreset_mode not in (AutoresetMode.NEXT_STEP, AutoresetMode.DISABLED):
            raise ValueError(
                f"TorchVectorEnv supports NEXT_STEP and DISABLED autoreset, got {autoreset_mode}"
            )
        self.device = resolve_device(device)
        self.func_env = func_env
        self.num_envs = num_envs
        self.params = params if params is not None else func_env.get_default_params()
        self.time_limit = max_episode_steps
        self.autoreset_mode = autoreset_mode
        self.metadata = dict(type(self).metadata)
        self.metadata["autoreset_mode"] = autoreset_mode
        if sharding is not None:
            from gymnasium_tpu_torch.parallel.mesh import NamedSharding

            if not isinstance(sharding, NamedSharding):
                raise ValueError(f"sharding must be a NamedSharding over the env axis, got {type(sharding).__name__}")
        self.sharding = sharding

        self.single_observation_space, self.single_action_space = wrapped_spaces(func_env, self.wrappers)
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

        self._batched = vectorize_func_env(func_env, num_envs)
        self._step_fn = self._make_step(self._batched)
        self._sharded: dict = {}
        self._seed = seed if seed is not None else 0
        self.carry: EnvCarry | WrappedEnvCarry | None = None
        self._last_obs: torch.Tensor | None = None

    def _make_step(self, batched: FuncEnv):
        step = make_autoreset_step(
            batched,
            self.params,
            time_limit=self.time_limit,
            autoreset=self.autoreset_mode == AutoresetMode.NEXT_STEP,
        )
        return wrap_autoreset_step(step, self.wrappers) if self.wrappers else step

    def _generator(self, seed: int) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return generator

    def _initial(self, rng: torch.Generator, batched: FuncEnv | None = None):
        """Fresh ``(carry, obs)`` drawn from ``rng``, the wrappers initialised."""
        carry, obs = make_initial_carry(batched or self._batched, rng, self.params)
        if not self.wrappers:
            return carry, obs
        return wrap_initial(self.wrappers, rng, carry, obs, self.params)

    # -- sharding -----------------------------------------------------------

    def _shard_of(self, carry):
        """The carry's env shard, None for a carry on one device: on one
        device this costs one type check of a carry leaf."""
        steps = (carry.env if self.wrappers else carry).steps
        if type(steps) is torch.Tensor:
            return None
        from gymnasium_tpu_torch.parallel.mesh import shard_of

        return shard_of(steps)

    def _sharded_parts(self, shard) -> tuple[FuncEnv, Any]:
        """The batched env and the step over this rank's rows of ``shard``."""
        parts = self._sharded.get(shard)
        if parts is None:
            batched = vectorize_func_env(self.func_env, self.num_envs, sharding=shard)
            parts = self._sharded[shard] = (batched, self._make_step(batched))
        return parts

    def _local_actions(self, actions, shard):
        """This rank's rows of a step's actions: a DTensor's local part, the
        rows of a whole batch, or a batch of the local size as it is."""
        from gymnasium_tpu_torch.parallel.mesh import DTensor

        if isinstance(actions, DTensor):
            return actions.to_local()
        actions = torch.as_tensor(actions, device=self.device)
        if actions.dim() > 0 and actions.shape[0] == self.num_envs:
            return shard.take(actions)
        return actions

    # -- VectorEnv API ------------------------------------------------------

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        if options is not None and "reset_mask" in options:
            return self._partial_reset(options["reset_mask"], seed)
        if seed is not None:
            self._seed = seed
        if self.sharding is None:
            self.carry, obs = self._initial(self._generator(self._seed))
        else:
            # this rank's rows, placed as JAX's _place places the whole carry
            from gymnasium_tpu_torch.parallel.mesh import shard_for, wrap

            shard = shard_for(self.sharding)
            with use_shard(shard):
                carry, obs = self._initial(self._generator(self._seed), self._sharded_parts(shard)[0])
            per_env = per_env_mask(carry, shard.local_count(self.num_envs), self.wrappers)
            self.carry, obs = wrap(carry, per_env, shard), wrap(obs, True, shard)
        self._last_obs = obs
        return obs, {}

    def _partial_reset(self, reset_mask, seed: int | None):
        """Masked reset: only ``reset_mask`` lanes re-initialise; the others
        keep their state and report their last observation. Shared wrapper
        state (the normalisation statistics) keeps its live value."""
        if self.carry is None:
            raise RuntimeError("Call reset before a masked reset.")
        reset_mask = np.asarray(reset_mask)
        if reset_mask.shape != (self.num_envs,):
            raise ValueError(
                f"`options['reset_mask': mask]` must have shape `({self.num_envs},)`, "
                f"got {reset_mask.shape}"
            )
        if reset_mask.dtype != np.bool_:
            raise ValueError(
                f"`options['reset_mask': mask]` must have `dtype=np.bool_`, got {reset_mask.dtype}"
            )
        if not reset_mask.any():
            raise ValueError("`options['reset_mask': mask]` must contain at least one True entry")

        # the carried generator continues its stream unless a seed restarts it
        env = self.carry.env if self.wrappers else self.carry
        rng = self._generator(seed) if seed is not None else env.rng
        shard = self._shard_of(self.carry)
        mask = torch.as_tensor(reset_mask, device=self.device)
        if shard is None:
            self.carry, self._last_obs = self._merge(mask, rng, self._batched, self.carry, self._last_obs)
            return self._last_obs, {}
        from gymnasium_tpu_torch.parallel.mesh import on_shard

        batched = self._sharded_parts(shard)[0]
        self.carry, self._last_obs = on_shard(
            lambda carry, obs: self._merge(shard.take(mask), rng, batched, carry, obs), shard, self.carry, self._last_obs
        )
        return self._last_obs, {}

    def _merge(self, mask, rng, batched, carry, last_obs):
        """The carry and obs with the ``mask`` lanes taken from fresh ones
        that ``batched`` draws from ``rng``."""
        fresh, fresh_obs = self._initial(rng, batched)
        per_env = per_env_mask(carry, mask.shape[0], self.wrappers)

        def merge(per_env, new, old):
            if isinstance(old, torch.Generator):
                return rng
            if not per_env:
                return old
            return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        carry = tree_map(merge, per_env, fresh, carry)
        return carry, tree_map(lambda new, old: merge(True, new, old), fresh_obs, last_obs)

    def step(self, actions):
        if self.carry is None:
            raise RuntimeError("Call reset before using step method.")
        shard = self._shard_of(self.carry)
        with span("vector.step"):
            if shard is None:
                actions = torch.as_tensor(actions, device=self.device)
                self.carry, timestep = self._step_fn(self.carry, actions)
            else:
                from gymnasium_tpu_torch.parallel.mesh import on_shard

                step = self._sharded_parts(shard)[1]
                self.carry, timestep = on_shard(
                    lambda carry: step(carry, self._local_actions(actions, shard)), shard, self.carry
                )
        self._last_obs = timestep.obs
        return (
            timestep.obs,
            timestep.reward,
            timestep.terminated,
            timestep.truncated,
            timestep.info,
        )

    # -- rollout (benchmark / training path) --------------------------------

    def rollout(
        self,
        num_steps: int,
        action_fn: Callable[[torch.Generator, torch.Tensor], Any] | None = None,
        carry: EnvCarry | WrappedEnvCarry | None = None,
    ) -> tuple[EnvCarry | WrappedEnvCarry, TimeStep]:
        """Run ``num_steps`` env steps from ``carry`` (default: the env's own).

        ``action_fn(rng, obs) -> actions`` defaults to uniform random actions
        from the action space, drawn from the carry's generator. Unlike the
        JAX rollout, which passes ``None``, ``obs`` is the current batched
        observation: the env's last one, or for a ``carry`` passed in, the
        observation of its env state before any wrapper. Returns ``(carry,
        TimeStep)`` with time-major stacked leaves, info included.

        On a sharded carry each rank steps its rows: ``obs`` is this rank's
        rows, ``action_fn`` may return the whole batch's actions or this
        rank's, and the trajectory's leaves are DTensors sharded along the
        env axis (dimension 1).
        """
        if carry is None:
            if self.carry is None:
                self.reset()
            carry, obs = self.carry, self._last_obs
        else:
            obs = None
        if action_fn is None:
            space = self.single_action_space

            def action_fn(rng, obs):
                return space.sample_torch(rng, (self.num_envs,), self.device)

        shard = self._shard_of(carry)
        step = self._step_fn if shard is None else self._sharded_parts(shard)[1]

        def run(carry, obs):
            env = carry.env if self.wrappers else carry
            if obs is None:
                obs = self._batched.observation(env.state, env.rng, self.params)
            steps = []
            for _ in range(num_steps):
                with span("vector.step"):
                    with span("vector.actions"):
                        actions = action_fn(env.rng, obs)
                    if shard is not None:
                        actions = self._local_actions(actions, shard)
                    carry, ts = step(carry, actions)
                obs = ts.obs
                steps.append(ts)
            traj = TimeStep(
                obs=torch.stack([ts.obs for ts in steps]),
                reward=torch.stack([ts.reward for ts in steps]),
                terminated=torch.stack([ts.terminated for ts in steps]),
                truncated=torch.stack([ts.truncated for ts in steps]),
                info={key: torch.stack([ts.info[key] for ts in steps]) for key in steps[-1].info},
            )
            return carry, obs, traj

        with span("vector.rollout"):
            if shard is None:
                carry, obs, traj = run(carry, obs)
            else:
                from gymnasium_tpu_torch.parallel.mesh import on_shard

                carry, obs, traj = on_shard(run, shard, carry, obs, dims=(0, 1))
        self.carry = carry
        self._last_obs = obs
        return carry, traj

    def render(self):
        return None
