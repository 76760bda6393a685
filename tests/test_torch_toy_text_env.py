"""The port's toy-text host env classes against the JAX package's, through
``make(id)``: Blackjack, FrozenLake (4x4 and 8x8), CliffWalking (plain and
slippery) and Taxi.

JAX's classes are plain numpy and call no JAX; the port's are the same code
over the port's ``Env``, spaces, canvas and dense models. Every output is
equal bit for bit: the reset and 200 steps of one action stream, the
generators after every call, ``rgb_array`` frames and ``ansi`` text, and the
variants (Blackjack's ``natural`` and ``sab`` rules, FrozenLake's random
maps and options, Taxi's ``is_rainy`` and ``fickle_passenger``).
"""

import numpy as np
import pytest

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.toy_text import blackjack as jblackjack
from gymnasium_tpu.envs.toy_text import frozen_lake as jfrozen_lake
from gymnasium_tpu.envs.toy_text import utils as jutils
from gymnasium_tpu_torch.envs.toy_text import blackjack, frozen_lake
from gymnasium_tpu_torch.envs.toy_text import utils as toy_utils
from tests.torch_compare import assert_host_env_matches_jax, assert_identical

TOY_TEXT = {
    "Blackjack-v1": "BlackjackEnv",
    "FrozenLake-v1": "FrozenLakeEnv",
    "FrozenLake8x8-v1": "FrozenLakeEnv",
    "CliffWalking-v1": "CliffWalkingEnv",
    "CliffWalkingSlippery-v1": "CliffWalkingEnv",
    "Taxi-v3": "TaxiEnv",
}
TEXT_IDS = ("FrozenLake-v1", "FrozenLake8x8-v1", "CliffWalking-v1", "CliffWalkingSlippery-v1", "Taxi-v3")
STEPS = 200


@pytest.mark.parametrize("env_id", sorted(TOY_TEXT))
def test_make_matches_jax_bit_for_bit(env_id):
    port, ref = gym.make(env_id, render_mode="rgb_array"), jgym.make(env_id, render_mode="rgb_array")
    assert type(port.unwrapped).__name__ == TOY_TEXT[env_id]
    assert type(port.unwrapped).__module__.startswith("gymnasium_tpu_torch.envs.toy_text.")
    assert_host_env_matches_jax(port, ref, STEPS, seed=4, render_every=25)


@pytest.mark.parametrize("env_id", TEXT_IDS)
def test_ansi_text_matches_jax_at_every_step(env_id):
    port, ref = gym.make(env_id, render_mode="ansi"), jgym.make(env_id, render_mode="ansi")
    assert_host_env_matches_jax(port, ref, 60, seed=6, render_every=1)


@pytest.mark.parametrize("size", [4, 8])
def test_generate_random_map_matches_jax(size):
    for seed in range(10):
        board = frozen_lake.generate_random_map(size, seed=seed)
        assert board == jfrozen_lake.generate_random_map(size, seed=seed)
        assert len(board) == size and board[0][0] == "S" and board[-1][-1] == "G"
        cells = np.asarray([list(row) for row in board])
        assert frozen_lake._has_path(cells, size) and jfrozen_lake._has_path(cells, size)
    assert frozen_lake.generate_random_map(size, p=0.6, seed=3) == jfrozen_lake.generate_random_map(size, p=0.6, seed=3)


@pytest.mark.parametrize("kwargs", [
    {"desc": "random8"},
    {"is_slippery": False},
    {"map_name": "8x8", "success_rate": 0.5, "reward_schedule": (2, -1, 0)},
], ids=["random_map", "not_slippery", "success_rate_and_rewards"])
def test_frozen_lake_options_match_jax(kwargs):
    if kwargs.get("desc") == "random8":
        kwargs = {"desc": frozen_lake.generate_random_map(8, seed=11)}
    port = gym.make("FrozenLake-v1", render_mode="ansi", **kwargs)
    ref = jgym.make("FrozenLake-v1", render_mode="ansi", **kwargs)
    assert port.unwrapped.reward_range == ref.unwrapped.reward_range
    assert port.unwrapped.P == ref.unwrapped.P
    assert_host_env_matches_jax(port, ref, 120, seed=8, render_every=3)


@pytest.mark.parametrize("rules", [{"natural": True}, {"sab": True}, {"natural": True, "sab": True}],
                         ids=["natural", "sab", "sab_over_natural"])
def test_blackjack_rules_match_jax(rules):
    port, ref = gym.make("Blackjack-v1", **rules), jgym.make("Blackjack-v1", **rules)
    assert assert_host_env_matches_jax(port, ref, 400, seed=9) > 100


def test_blackjack_hand_helpers_match_jax():
    rng = np.random.default_rng(0)
    hands = [list(rng.choice(blackjack.DECK, n)) for n in rng.integers(2, 6, 300)] + [[1, 10], [10, 1], [1, 1, 9]]
    for hand in hands:
        for name in ("usable_ace", "sum_hand", "is_bust", "score", "is_natural"):
            assert_identical(getattr(blackjack, name)(hand), getattr(jblackjack, name)(hand), f"{name}({hand})")
    for a, b in ((3, 5), (5, 3), (4, 4)):
        assert_identical(blackjack.cmp(a, b), jblackjack.cmp(a, b))
    got, want = np.random.default_rng(5), np.random.default_rng(5)
    assert [blackjack.draw_hand(got) for _ in range(50)] == [jblackjack.draw_hand(want) for _ in range(50)]
    assert_identical(blackjack.draw_card(got), jblackjack.draw_card(want))


def test_taxi_rainy_and_fickle_match_jax():
    port = gym.make("Taxi-v3", is_rainy=True, fickle_passenger=True, render_mode="ansi")
    ref = jgym.make("Taxi-v3", is_rainy=True, fickle_passenger=True, render_mode="ansi")
    for seed in range(4):
        assert_host_env_matches_jax(port, ref, 100, seed=seed, render_every=7)
    for state in (0, 17, 123, 499):
        assert_identical(port.unwrapped.action_mask(state), ref.unwrapped.action_mask(state))
        assert list(port.unwrapped.decode(state)) == list(ref.unwrapped.decode(state))


def test_categorical_sample_matches_jax():
    got, want = np.random.default_rng(2), np.random.default_rng(2)
    for probs in ([0.2, 0.5, 0.3], [1.0], [0.0, 0.0, 1.0], np.full(16, 1 / 16)):
        for _ in range(20):
            assert_identical(toy_utils.categorical_sample(probs, got), jutils.categorical_sample(probs, want))
