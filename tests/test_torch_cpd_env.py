"""The port's blockchain CPD host env classes against the JAX package's:
``BlockchainCPDEnv`` through ``make(id)`` for its three ids, its options, the
unregistered ``MultiAgentBlockchainCPDEnv``, and the whole-array helpers.

Both are plain numpy in float64, so every output is equal bit for bit: the
reset and 200 steps of one action stream, ``info`` with each round's record,
the generators after every call, and the ``ansi`` text.
"""

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.blockchain import cpd_env as jcpd
from gymnasium_tpu_torch.envs.blockchain import cpd_env as cpd
from tests.torch_compare import assert_host_env_matches_jax, assert_identical

CPD_IDS = ("BlockchainCPD-v0", "BlockchainCPD-v0-Random", "BlockchainCPD-v0-TFT")
STEPS = 200


@pytest.mark.parametrize("env_id", CPD_IDS)
def test_make_matches_jax_bit_for_bit(env_id):
    port, ref = gym.make(env_id, render_mode="ansi"), jgym.make(env_id, render_mode="ansi")
    assert type(port.unwrapped) is cpd.BlockchainCPDEnv
    assert port.unwrapped.opponent_policy == ref.unwrapped.opponent_policy
    assert assert_host_env_matches_jax(port, ref, STEPS, seed=1, render_every=1) == 2
    assert_identical(port.unwrapped.get_history(), ref.unwrapped.get_history())
    assert_identical(port.unwrapped.get_last_n_rounds(3), ref.unwrapped.get_last_n_rounds(3))


@pytest.mark.parametrize("kwargs", [
    {"num_miners": 4, "agent_id": 2, "opponent_policy": "random"},
    {"num_miners": 3, "alpha": [0.5, 0.3, 0.2], "opponent_policy": "tit_for_tat", "beta": 1.2, "kappa": 0.1},
], ids=["four_miners_random", "alpha_tit_for_tat"])
def test_options_match_jax(kwargs):
    port, ref = gym.make("BlockchainCPD-v0", **kwargs), jgym.make("BlockchainCPD-v0", **kwargs)
    assert_host_env_matches_jax(port, ref, 60, seed=2)
    options = {"alpha": [1.0] + [2.0] * (kwargs["num_miners"] - 1)}
    assert_host_env_matches_jax(port, ref, 20, seed=3, options=options)


def test_bad_arguments_raise_as_jax_does():
    for kwargs in ({"num_miners": 1}, {"agent_id": 5}, {"opponent_policy": "greedy"}):
        with pytest.raises(AssertionError) as got:
            cpd.BlockchainCPDEnv(**kwargs)
        with pytest.raises(AssertionError) as want:
            jcpd.BlockchainCPDEnv(**kwargs)
        assert str(got.value) == str(want.value)


def test_multi_agent_env_matches_jax():
    port = cpd.MultiAgentBlockchainCPDEnv(num_miners=3, alpha=[0.2, 0.3, 0.5], max_rounds=40)
    ref = jcpd.MultiAgentBlockchainCPDEnv(num_miners=3, alpha=[0.2, 0.3, 0.5], max_rounds=40)
    assert_identical(port.reset(seed=0), ref.reset(seed=0))
    rng = np.random.default_rng(0)
    for k in range(40):
        actions = rng.uniform(0, 1, (3, 3)) * (rng.uniform(size=(3, 1)) < 0.9)
        got, want = port.step(actions), ref.step(actions)
        assert_identical(got, want, f"round {k}")
    assert got[2] is True
    assert_identical(port.get_history(), ref.get_history())


def test_whole_array_helpers_match_jax():
    rng = np.random.default_rng(1)
    actions = rng.uniform(-0.5, 1.0, (64, 3))
    actions[:4] = 0.0
    assert_identical(cpd.simplex_normalize(actions), jcpd.simplex_normalize(actions))
    for n in (2, 5):
        acts = cpd.simplex_normalize(rng.uniform(0, 1, (n, 3)))
        eta, alpha = rng.uniform(0.1, 1.0, n), rng.dirichlet(np.ones(n))
        assert_identical(cpd._mean_opponent(eta), jcpd._mean_opponent(eta))
        assert_identical(cpd.compute_utilities(acts, eta, alpha, 10.0, 1.5, 2.0),
                         jcpd.compute_utilities(acts, eta, alpha, 10.0, 1.5, 2.0))
        assert_identical(cpd.update_efficiencies(acts, eta, 0.3, 0.05, 0.1),
                         jcpd.update_efficiencies(acts, eta, 0.3, 0.05, 0.1))
