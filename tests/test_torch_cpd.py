"""The port's blockchain CPD game against the JAX package's ``BlockchainCPDFunctional``.

JAX's game is written for one env and vmapped over states and keys here;
the port's is batch-first. For the ``"random"`` policy JAX draws
``dirichlet(key, ones(3), (M,))`` from each lane's transition key: the test
recomputes those draws outside ``jit`` and feeds them to the port's
``transition_values``. Eight rounds are chained from random states, each
side stepping its own state, for every opponent policy, two and three
miners and a custom ``alpha``: states, observations and rewards agree within
``1e-6 * max |JAX| + 1e-6`` a leaf (a cumulative reward of order 1e1 may
cancel to near 0 and keep an error of its summands' size), ``round`` and the
terminal flag are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.blockchain.cpd_functional import BlockchainCPDFunctional as JaxCPD
from gymnasium_tpu_torch.envs.blockchain import BlockchainCPDFunctional

N, ROUNDS, TOL = 512, 8, 1e-6
CASES = {
    "honest": {"opponent_policy": "honest"},
    "random": {"opponent_policy": "random", "num_miners": 3, "agent_id": 1, "alpha": [0.5, 0.2, 0.3]},
    "tit_for_tat": {"opponent_policy": "tit_for_tat", "num_miners": 3, "max_rounds": 10},
    "random_two": {"opponent_policy": "random", "max_rounds": 5, "kappa": 0.5},
}


def jax_dirichlet(keys, m):
    return np.array(jax.vmap(lambda k: jax.random.dirichlet(k, jnp.ones(3), (m,)))(keys))


def _start(env, rng):
    """Random mid-game states: efficiencies in [eta_min, 1], some rounds near the end."""
    m = env.num_miners
    return {
        "eta": rng.uniform(0.1, 1.0, (N, m)).astype(np.float32),
        "prev_opp_eta": rng.uniform(0.1, 1.0, N).astype(np.float32),
        "cum": rng.uniform(-5, 20, (N, m)).astype(np.float32),
        "last_reward": rng.uniform(-2, 5, N).astype(np.float32),
        "last_agent_action": rng.dirichlet(np.ones(3), N).astype(np.float32),
        "round": rng.integers(0, env.max_rounds, N).astype(np.int32),
    }


def _close(got, want, label):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, label
    np.testing.assert_allclose(got, want, rtol=0.0, atol=TOL * float(np.abs(want).max(initial=0.0)) + TOL,
                               err_msg=label)


@pytest.mark.parametrize("case", sorted(CASES))
def test_rounds_match_jax_with_its_draws(case):
    env, jenv = BlockchainCPDFunctional(dict(CASES[case])), JaxCPD(dict(CASES[case]))
    params, jparams = env.get_default_params(), jenv.get_default_params()
    np.testing.assert_array_equal(np.asarray(params.alpha, np.float32), np.asarray(jparams.alpha))
    rng = np.random.default_rng(0)
    state = _start(env, rng)
    pstate, jstate = {k: torch.from_numpy(v) for k, v in state.items()}, {k: jnp.asarray(v) for k, v in state.items()}
    step = jax.jit(jax.vmap(jenv.transition, in_axes=(0, 0, 0, None)))
    observe = jax.jit(jax.vmap(jenv.observation, in_axes=(0, None, None)))
    terminal = jax.jit(jax.vmap(jenv.terminal, in_axes=(0, None, None)))
    gen, ended = torch.Generator(), 0
    for r in range(ROUNDS):
        # some actions sum below 1e-8 and take the honest fallback; some are negative
        action = rng.uniform(-0.2, 1.0, (N, 3)).astype(np.float32)
        action[::16] = 0.0
        keys = jax.random.split(jax.random.PRNGKey(r), N)
        jnext = step(jstate, jnp.asarray(action), keys, jparams)
        draws = torch.from_numpy(jax_dirichlet(keys, env.num_miners)) if env.opponent_policy == "random" else None
        pnext = env.transition_values(pstate, torch.from_numpy(action), draws, params)
        for key in jnext:
            _close(pnext[key], jnext[key], f"round {r} {key}")
        _close(env.observation(pnext, gen, params), observe(jnext, None, jparams), f"round {r} observation")
        _close(env.reward(pstate, action, pnext, gen, params), jnext["last_reward"], f"round {r} reward")
        done = env.terminal(pnext, gen, params).numpy()
        np.testing.assert_array_equal(done, np.asarray(terminal(jnext, None, jparams)))
        ended += int(done.sum())
        pstate, jstate = pnext, jnext
    assert ended > 0


def test_random_opponents_draw_dirichlet_splits_from_the_generator():
    """Three Exp(1) draws over their sum a miner, from the generator passed in:
    uniform on the simplex, each part of mean 1/3 and variance 1/18."""
    n, m = 4096, 4
    env = BlockchainCPDFunctional({"opponent_policy": "random", "num_miners": m})
    state = env.initial_batched(torch.Generator(), n)
    action = torch.rand((n, 3), generator=torch.Generator().manual_seed(1))
    got = env.transition(state, action, torch.Generator().manual_seed(0))
    e = torch.empty((n, m, 3)).exponential_(generator=torch.Generator().manual_seed(0))
    splits = e / e.sum(dim=-1, keepdim=True)
    want = env.transition_values(state, action, splits)
    assert all(torch.equal(got[k], want[k]) for k in want)
    mean = splits.reshape(-1, 3).mean(dim=0).double()
    assert bool(((mean - 1 / 3).abs() < 3 * (1 / 18 / (n * m)) ** 0.5).all())


def test_initial_matches_jax_and_the_spaces_are_declared_float64():
    env, jenv = BlockchainCPDFunctional({"num_miners": 3}), JaxCPD({"num_miners": 3})
    got = env.initial(torch.Generator())
    want = jenv.initial(None)
    for key in want:
        _close(got[key], want[key], key)
    assert env.observation_space.dtype == np.float64 and env.action_space.dtype == np.float64
    np.testing.assert_array_equal(env.observation_space.low, jenv.observation_space.low)
    np.testing.assert_array_equal(env.observation_space.high, jenv.observation_space.high)
