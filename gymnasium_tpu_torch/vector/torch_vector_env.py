"""Device-resident vector env over a batch-first :class:`FuncEnv`.

Counterpart of the JAX package's ``vector/jax_vector_env.py::JaxVectorEnv``.
The whole batch lives on one device; ``step`` is the auto-resetting step of
:func:`~gymnasium_tpu_torch.functional.make_autoreset_step`, and ``rollout``
runs it in a plain Python loop where the JAX class compiles a ``lax.scan``.
No step reads a value back to the host.
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
    vectorize_func_env,
)
from gymnasium_tpu_torch.utils.device import resolve_device
from gymnasium_tpu_torch.vector.utils import batch_space
from gymnasium_tpu_torch.vector.vector_env import AutoresetMode, VectorEnv

__all__ = ["TorchVectorEnv"]


class TorchVectorEnv(VectorEnv):
    """Batched auto-resetting env whose state stays on ``device`` (CUDA by default)."""

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
        if sharding is not None:
            raise NotImplementedError("sharding the env batch is not ported yet")
        if wrappers:
            raise NotImplementedError("functional wrapper stacks are not ported yet")
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

        self.single_observation_space = func_env.observation_space
        self.single_action_space = func_env.action_space
        self.observation_space = batch_space(self.single_observation_space, num_envs)
        self.action_space = batch_space(self.single_action_space, num_envs)

        self._batched = vectorize_func_env(func_env, num_envs)
        self._step_fn = make_autoreset_step(
            self._batched,
            self.params,
            time_limit=self.time_limit,
            autoreset=autoreset_mode == AutoresetMode.NEXT_STEP,
        )
        self._seed = seed if seed is not None else 0
        self.carry: EnvCarry | None = None
        self._last_obs: torch.Tensor | None = None

    def _generator(self, seed: int) -> torch.Generator:
        generator = torch.Generator(device=self.device)
        generator.manual_seed(seed)
        return generator

    # -- VectorEnv API ------------------------------------------------------

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        if options is not None and "reset_mask" in options:
            return self._partial_reset(options["reset_mask"], seed)
        if seed is not None:
            self._seed = seed
        self.carry, obs = make_initial_carry(self._batched, self._generator(self._seed), self.params)
        self._last_obs = obs
        return obs, {}

    def _partial_reset(self, reset_mask, seed: int | None):
        """Masked reset: only ``reset_mask`` lanes re-initialise; the others
        keep their state and report their last observation."""
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
        rng = self._generator(seed) if seed is not None else self.carry.rng
        fresh, fresh_obs = make_initial_carry(self._batched, rng, self.params)
        mask = torch.as_tensor(reset_mask, device=self.device)

        def merge(new, old):
            return torch.where(mask.reshape((-1,) + (1,) * (new.dim() - 1)), new, old)

        self.carry = EnvCarry(
            state=merge(fresh.state, self.carry.state),
            rng=rng,
            steps=merge(fresh.steps, self.carry.steps),
            prev_done=merge(fresh.prev_done, self.carry.prev_done),
        )
        self._last_obs = merge(fresh_obs, self._last_obs)
        return self._last_obs, {}

    def step(self, actions):
        if self.carry is None:
            raise RuntimeError("Call reset before using step method.")
        actions = torch.as_tensor(actions, device=self.device)
        self.carry, timestep = self._step_fn(self.carry, actions)
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
        carry: EnvCarry | None = None,
    ) -> tuple[EnvCarry, TimeStep]:
        """Run ``num_steps`` env steps from ``carry`` (default: the env's own).

        ``action_fn(rng, obs) -> actions`` defaults to uniform random actions
        from the action space, drawn from the carry's generator. Unlike the
        JAX rollout, which passes ``None``, ``obs`` is the current batched
        observation. Returns ``(carry, TimeStep)`` with time-major stacked
        leaves.
        """
        if carry is None:
            if self.carry is None:
                self.reset()
            carry = self.carry
        if action_fn is None:
            space = self.single_action_space

            def action_fn(rng, obs):
                return space.sample_torch(rng, (self.num_envs,), self.device)

        obs = self._batched.observation(carry.state, carry.rng, self.params)
        steps = []
        for _ in range(num_steps):
            carry, ts = self._step_fn(carry, action_fn(carry.rng, obs))
            obs = ts.obs
            steps.append(ts)
        traj = TimeStep(
            obs=torch.stack([ts.obs for ts in steps]),
            reward=torch.stack([ts.reward for ts in steps]),
            terminated=torch.stack([ts.terminated for ts in steps]),
            truncated=torch.stack([ts.truncated for ts in steps]),
            info={},
        )
        self.carry = carry
        self._last_obs = obs
        return carry, traj

    def render(self):
        return None
