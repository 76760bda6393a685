"""The port's Blackjack against the JAX package's ``BlackjackFunctional``.

JAX draws each card with ``randint(key, (), 0, 13)``: the deal from
``split(rng, 4)`` (dealer, dealer, player, player), a step's hit card from the
first half of ``split(rng)`` and the dealer's k-th card from the k-th split of
the second half (``key, k = split(key)`` a loop iteration). The tests
recompute those card indices outside ``jit`` for each lane's key and feed
them to the port's ``reset_values`` and ``transition_values``: every leaf of
the state, the observation, the reward and the flag are identical to JAX's,
under the default rules, ``natural`` and ``sab``. The port plays the dealer
out with ``DEALER_DRAWS`` masked draws, a bound found here by exhaustive
search; a lane that needs every one of them is held to a plain loop.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.tabular.blackjack import BlackjackFunctional as JaxBlackjack
from gymnasium_tpu_torch.envs.tabular.blackjack import DEALER_DRAWS, DECK, BlackjackFunctional

N = 4096
RULES = {"default": {}, "natural": {"natural": True}, "sab": {"sab": True}}


def _randint(key):
    return jax.random.randint(key, (), 0, len(DECK))


@jax.jit
@jax.vmap
def jax_deal_cards(key):
    """The four card indices JAX's ``initial`` draws from ``key``."""
    return jax.vmap(_randint)(jax.random.split(key, 4))


@jax.jit
@jax.vmap
def jax_step_cards(key):
    """The hit card and the dealer's ``DEALER_DRAWS`` card indices JAX's
    ``transition`` draws from ``key``."""
    k_hit, key = jax.random.split(key)
    dealer = []
    for _ in range(DEALER_DRAWS):
        key, k = jax.random.split(key)
        dealer.append(_randint(k))
    return _randint(k_hit), jnp.stack(dealer)


def keys(seed, n=N):
    return jax.random.split(jax.random.PRNGKey(seed), n)


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_identical(got, want):
    for key, value in want.items():
        value = np.asarray(value)
        assert got[key].numpy().dtype == value.dtype, key
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_deal_is_identical_to_jax():
    env, jenv = BlackjackFunctional(), JaxBlackjack()
    k = keys(0)
    want = jax.vmap(jenv.initial, in_axes=(0, None))(k, None)
    got = env.reset_values(torch.from_numpy(np.array(jax_deal_cards(k))))
    assert_identical(got, want)
    assert got["p_nat"].any() and got["d_nat"].any() and got["p_ace"].any()


def _mid_hand_states(jenv, seed):
    """JAX's deals, half of them after one hit that did not bust."""
    deal = jax.vmap(jenv.initial, in_axes=(0, None))(keys(seed), None)
    hit = jax.vmap(jenv.transition, in_axes=(0, 0, 0, None))(deal, jnp.ones(N, jnp.int32), keys(seed + 1), None)
    pick = (np.arange(N) % 2 == 1) & ~np.asarray(hit["done"])
    return {k: np.where(pick, np.asarray(hit[k]), np.asarray(deal[k])) for k in deal}


@pytest.mark.parametrize("rules", sorted(RULES))
def test_step_is_identical_to_jax_with_its_cards(rules):
    env, jenv = BlackjackFunctional(RULES[rules]), JaxBlackjack(RULES[rules])
    state = _mid_hand_states(jenv, 2)
    action = np.random.default_rng(3).integers(0, 2, N).astype(np.int32)
    k = keys(4)
    want = jax.vmap(jenv.transition, in_axes=(0, 0, 0, None))(
        {key: jnp.asarray(v) for key, v in state.items()}, jnp.asarray(action), k, None)
    hit_card, dealer_cards = (torch.from_numpy(np.array(x)) for x in jax_step_cards(k))
    pstate = to_torch(state)
    got = env.transition_values(pstate, torch.from_numpy(action), hit_card, dealer_cards)
    assert_identical(got, want)

    gen = torch.Generator()
    want_obs = jax.vmap(jenv.observation, in_axes=(0, None, None))(want, None, None)
    obs = env.observation(got, gen)
    assert obs.dtype == torch.int32 and obs.shape == (N, 3)
    np.testing.assert_array_equal(obs.numpy(), np.asarray(want_obs))
    assert env.observation_space.contains_torch(obs)
    np.testing.assert_array_equal(env.reward(pstate, action, got, gen).numpy(), np.asarray(want["r"]))
    np.testing.assert_array_equal(env.terminal(got, gen).numpy(), np.asarray(want["done"]))
    payouts = set(np.unique(got["r"].numpy()).tolist())
    assert {-1.0, 0.0, 1.0} <= payouts and (1.5 in payouts) == (rules == "natural")
    # the dealers of this batch drew up to several cards
    drawn = (got["d_sum"] - pstate["d_sum"])[torch.from_numpy(action) == 0]
    assert int(drawn.max()) >= 20


def _best(raw, ace):
    return raw + 10 if ace and raw + 10 <= 21 else raw


def max_dealer_draws() -> int:
    """The most cards the dealer draws, from any two-card hand, before its
    best sum reaches 17: a longest path over its (raw sum, holds an ace)
    states, each card value a branch."""
    values = sorted(set(DECK))
    memo = {}

    def longest(raw, ace):
        if _best(raw, ace) >= 17:
            return 0
        if (raw, ace) not in memo:
            memo[raw, ace] = 1 + max(longest(raw + v, ace or v == 1) for v in values)
        return memo[raw, ace]

    return max(longest(a + b, a == 1 or b == 1) for a in values for b in values)


def test_dealer_draw_bound_is_the_exhaustive_search_result():
    assert max_dealer_draws() == DEALER_DRAWS == 10


def _dealer_loop(raw, ace, cards):
    """The dealer's play-out as JAX's while loop runs it, card by card."""
    used = 0
    while _best(raw, ace) < 17:
        value = DECK[cards[used]]
        raw, ace, used = raw + value, ace or value == 1, used + 1
    return raw, ace, used


def test_a_dealer_that_needs_every_draw():
    """Two aces, then four aces (raw 6, best 16), a six (12), five aces (17):
    the tenth card decides. Lanes differ only in that card."""
    env = BlackjackFunctional()
    ace, six = DECK.index(1), DECK.index(6)
    tenth = torch.arange(len(DECK))
    dealer = torch.tensor([ace] * 4 + [six] + [ace] * 4)[None, :].repeat(len(DECK), 1)
    dealer = torch.cat([dealer, tenth[:, None]], dim=1)
    n = dealer.shape[0]
    state = env.reset_values(torch.tensor([[ace, ace, 9, 6]]).repeat(n, 1))  # player 10 + 7
    got = env.transition_values(state, torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int64), dealer)
    for lane in range(n):
        raw, has_ace, used = _dealer_loop(2, True, dealer[lane].tolist())
        assert used == DEALER_DRAWS
        assert int(got["d_sum"][lane]) == raw and bool(got["d_ace"][lane]) == has_ace
        dealer_score = 0 if _best(raw, has_ace) > 21 else _best(raw, has_ace)
        assert float(got["r"][lane]) == float(np.sign(17 - dealer_score))
    # an ace ties at 17, a 2 to 5 makes 18 to 21, a 6 or more busts the dealer
    assert got["r"].tolist() == [0.0] + [-1.0] * 4 + [1.0] * (n - 5)


def test_generator_draws_reach_the_same_hooks():
    env = BlackjackFunctional()
    gen = torch.Generator().manual_seed(0)
    state = env.initial_batched(gen, 64)
    again = env.initial_batched(torch.Generator().manual_seed(0), 64)
    assert all(torch.equal(state[k], again[k]) for k in state)
    one = env.initial(torch.Generator().manual_seed(0))
    assert all(one[k].shape == () for k in one)
    stick = env.transition(state, torch.zeros(64, dtype=torch.int32), gen)
    assert bool(stick["done"].all()) and bool((_best_t(stick) >= 17).all())


def _best_t(state):
    usable = state["d_ace"] & (state["d_sum"] + 10 <= 21)
    return torch.where(usable, state["d_sum"] + 10, state["d_sum"])
