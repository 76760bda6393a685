"""The port's functional core and CartPole against the JAX package's.

Reset draws are injected into both sides (threefry and torch generators give
different numbers), so the trajectories must agree step for step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu import functional as jf
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu_torch import functional as tf
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

OBS_ATOL = 2e-5  # tests/ops/test_pallas_rollout.py:61


def _assert_step_equal(t_carry, t_ts, j_carry, j_ts, obs_atol=OBS_ATOL):
    np.testing.assert_allclose(t_ts.obs.numpy(), np.asarray(j_ts.obs), rtol=0, atol=obs_atol)
    np.testing.assert_array_equal(t_ts.reward.numpy(), np.asarray(j_ts.reward))
    np.testing.assert_array_equal(t_ts.terminated.numpy(), np.asarray(j_ts.terminated))
    np.testing.assert_array_equal(t_ts.truncated.numpy(), np.asarray(j_ts.truncated))
    np.testing.assert_array_equal(t_carry.steps.numpy(), np.asarray(j_carry.steps))
    np.testing.assert_array_equal(t_carry.prev_done.numpy(), np.asarray(j_carry.prev_done))


def test_cartpole_autoreset_step_matches_jax():
    n, num_steps, time_limit = 32, 320, 500
    rng = np.random.default_rng(0)
    state0 = rng.uniform(-0.05, 0.05, size=(n, 4)).astype(np.float32)
    # half the lanes start near the limit so truncation at 500 is reached
    steps0 = np.where(np.arange(n) < n // 2, rng.integers(480, 500, size=n), 0).astype(np.int32)
    actions = rng.integers(0, 2, size=(num_steps, n)).astype(np.int32)
    resets = rng.uniform(-0.05, 0.05, size=(num_steps, n, 4)).astype(np.float32)

    jfunc = JaxCartPole()
    jbatched = jf.vectorize_func_env(jfunc, n)
    jstep = jf.make_autoreset_step(jbatched, jfunc.get_default_params(), time_limit=time_limit)

    def injected(carry, action, reset_state):
        jbatched.initial = lambda rng, params=None: reset_state
        return jstep(carry, action)

    injected = jax.jit(injected)

    func = CartPoleFunctional()
    batched = tf.vectorize_func_env(func, n)
    step = tf.make_autoreset_step(batched, func.get_default_params(), time_limit=time_limit)

    jcarry = jf.EnvCarry(jnp.asarray(state0), jax.random.PRNGKey(0), jnp.asarray(steps0), jnp.zeros(n, bool))
    carry = tf.EnvCarry(
        torch.from_numpy(state0), torch.Generator(), torch.from_numpy(steps0), torch.zeros(n, dtype=torch.bool)
    )
    n_trunc = 0
    for s in range(num_steps):
        jcarry, jts = injected(jcarry, jnp.asarray(actions[s]), jnp.asarray(resets[s]))
        batched.initial = lambda rng, params=None, r=resets[s]: torch.from_numpy(r)
        carry, ts = step(carry, torch.from_numpy(actions[s]))
        _assert_step_equal(carry, ts, jcarry, jts)
        n_trunc += int(ts.truncated.sum())
    assert n_trunc > 0


def test_cartpole_hooks_match_jax():
    """Transition, observation, reward and terminal on the same batch."""
    n = 64
    rng = np.random.default_rng(1)
    state = rng.uniform(-0.3, 0.3, size=(n, 4)).astype(np.float32)
    action = rng.integers(0, 2, size=n).astype(np.int32)
    jfunc = jf.vectorize_func_env(JaxCartPole(), n)
    func = CartPoleFunctional()
    key, g = jax.random.PRNGKey(0), torch.Generator()
    t_state, t_action = torch.from_numpy(state), torch.from_numpy(action)
    j_state, j_action = jnp.asarray(state), jnp.asarray(action)
    np.testing.assert_allclose(
        func.transition(t_state, t_action, g).numpy(),
        np.asarray(jfunc.transition(j_state, j_action, key)),
        rtol=0,
        atol=1e-6,
    )
    np.testing.assert_array_equal(
        func.terminal(t_state, g).numpy(), np.asarray(jfunc.terminal(j_state, key))
    )
    np.testing.assert_array_equal(
        func.reward(t_state, t_action, t_state, g).numpy(),
        np.asarray(jfunc.reward(j_state, j_action, j_state, key)),
    )
    assert func.observation(t_state, g).dtype == torch.float32


def test_initial_batched_draws_reset_interval():
    func = CartPoleFunctional()
    g = torch.Generator().manual_seed(3)
    batched = tf.vectorize_func_env(func, 512)
    carry, obs = tf.make_initial_carry(batched, g, func.get_default_params())
    assert obs.shape == (512, 4) and obs.dtype == torch.float32
    assert float(obs.abs().max()) <= 0.05
    assert carry.steps.dtype == torch.int32 and not carry.steps.any()
    assert carry.prev_done.dtype == torch.bool and not carry.prev_done.any()
    # the same seed draws the same batch; per-env initial() stacks to the same shape
    again, _ = tf.make_initial_carry(batched, torch.Generator().manual_seed(3))
    assert torch.equal(carry.state, again.state)
    assert func.initial(torch.Generator()).shape == (4,)


class _JaxCounter(jf.FuncEnv):
    """Deterministic toy: the state counts up by the action; terminal at 4."""

    rng_hooks = frozenset()

    def initial(self, rng, params=None):
        return jnp.zeros((), jnp.float32)

    def transition(self, state, action, rng, params=None):
        return state + action

    def observation(self, state, rng, params=None):
        return state

    def reward(self, state, action, next_state, rng, params=None):
        return next_state - state

    def terminal(self, state, rng, params=None):
        return state >= 4


class _TorchCounter(tf.FuncEnv):
    """Batch-first twin of :class:`_JaxCounter`."""

    def initial(self, rng, params=None):
        return torch.zeros((), dtype=torch.float32)

    def transition(self, state, action, rng, params=None):
        return state + action

    def observation(self, state, rng, params=None):
        return state

    def reward(self, state, action, next_state, rng, params=None):
        return next_state - state

    def terminal(self, state, rng, params=None):
        return state >= 4


@pytest.mark.parametrize(
    "time_limit, autoreset", [(None, True), (None, False), (3, False), (6, True)]
)
def test_toy_env_branches_match_jax(time_limit, autoreset):
    n, num_steps = 8, 24
    actions = np.random.default_rng(2).integers(0, 2, size=(num_steps, n)).astype(np.float32)

    jbatched = jf.vectorize_func_env(_JaxCounter(), n)
    jstep = jax.jit(jf.make_autoreset_step(jbatched, time_limit=time_limit, autoreset=autoreset))
    jcarry, jobs = jf.make_initial_carry(jbatched, jax.random.PRNGKey(0))

    batched = tf.vectorize_func_env(_TorchCounter(), n)
    step = tf.make_autoreset_step(batched, time_limit=time_limit, autoreset=autoreset)
    carry, obs = tf.make_initial_carry(batched, torch.Generator())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))

    for s in range(num_steps):
        jcarry, jts = jstep(jcarry, jnp.asarray(actions[s]))
        carry, ts = step(carry, torch.from_numpy(actions[s]))
        _assert_step_equal(carry, ts, jcarry, jts, obs_atol=0)
        np.testing.assert_array_equal(carry.state.numpy(), np.asarray(jcarry.state))


def test_experimental_functional_is_the_functional_module():
    import gymnasium_tpu_torch as gym_torch
    import gymnasium_tpu_torch.experimental.functional as experimental_functional
    from gymnasium_tpu_torch import functional

    assert gym_torch.experimental.functional.FuncEnv is functional.FuncEnv
    assert experimental_functional.__all__ == functional.__all__
    assert all(getattr(experimental_functional, name) is getattr(functional, name) for name in functional.__all__)
