"""Blackjack as a batch-first functional env.

Counterpart of ``BlackjackFunctional`` in the JAX package's
``envs/tabular/blackjack.py``. The deck is infinite, so the state is the
raw sums and ace flags of both hands. JAX plays the dealer out with a
``lax.while_loop``; a loop whose condition the host reads would wait for the
card once per draw, so here the dealer runs :data:`DEALER_DRAWS` masked
draws on every lane: a lane whose hand reached 17 keeps it. The step draws
all of those cards up front, used or not. The render hooks draw one state
on the host, and :class:`BlackJackTorchEnv` is the named adapter of JAX's
``BlackJackJaxEnv``.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.functional import FuncEnv, tree_map
from gymnasium_tpu_torch.utils.device import to_host

__all__ = ["DEALER_DRAWS", "DECK", "BlackjackFunctional"]

#: Card values by draw index: ace, 2-9, and four ten-valued cards.
DECK = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 10, 10, 10)
#: The most cards the dealer can draw from any two-card hand before its best
#: sum reaches 17 (A, A, then four aces to 6, a 6 to 12, five aces to 17),
#: pinned by an exhaustive search in ``tests/test_torch_blackjack.py``.
DEALER_DRAWS = 10


@functools.lru_cache(maxsize=8)
def _deck(device: torch.device) -> torch.Tensor:
    return torch.tensor(DECK, dtype=torch.int32, device=device)


def _best(raw_sum, has_ace):
    """A hand's best sum and whether it counts an ace as 11."""
    usable = has_ace & (raw_sum + 10 <= 21)
    return torch.where(usable, raw_sum + 10, raw_sum), usable


def _score(raw_sum, has_ace):
    best, _ = _best(raw_sum, has_ace)
    return torch.where(best > 21, 0, best)


class BlackjackFunctional(FuncEnv):
    """Stateless blackjack. Options ``natural`` and ``sab``.

    State: a dict of (N,) leaves: ``p_sum``/``d_sum`` int32 (player's and
    dealer's raw sums), ``p_ace``/``d_ace`` bool (holds an ace), ``d_show``
    int32 (the dealer's face-up card), ``p_nat``/``d_nat`` bool (21 with the
    first two cards), ``done`` bool and ``r`` float32. The observation is
    ``[best player sum, dealer card, usable ace]`` as int32, a ``Box`` as
    in JAX.
    """

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        self.natural = bool(options.pop("natural", False))
        self.sab = bool(options.pop("sab", False))
        super().__init__(options)
        self.observation_space = spaces.Box(low=np.array([2, 1, 0]), high=np.array([31, 10, 1]), dtype=np.int32)
        self.action_space = spaces.Discrete(2)

    def reset_values(self, cards: torch.Tensor, params: Any = None) -> dict:
        """The deal of card indices ``cards`` (N, 4) in ``[0, 13)``: the
        dealer's two cards (the first face up), then the player's two."""
        d1, d2, p1, p2 = _deck(cards.device)[cards.long()].unbind(-1)
        p_sum, p_ace = p1 + p2, (p1 == 1) | (p2 == 1)
        d_sum, d_ace = d1 + d2, (d1 == 1) | (d2 == 1)
        return {
            "p_sum": p_sum,
            "p_ace": p_ace,
            "d_sum": d_sum,
            "d_ace": d_ace,
            "d_show": d1,
            "p_nat": _best(p_sum, p_ace)[0] == 21,
            "d_nat": _best(d_sum, d_ace)[0] == 21,
            "done": torch.zeros(p_sum.shape, dtype=torch.bool, device=cards.device),
            "r": torch.zeros(p_sum.shape, dtype=torch.float32, device=cards.device),
        }

    def initial(self, rng: torch.Generator, params: Any = None):
        return {k: v[0] for k, v in self.initial_batched(rng, 1, params).items()}

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` deals: card indices (n, 4)."""
        return (torch.randint(0, len(DECK), (n, 4), generator=rng, device=rng.device),)

    def initial_batched(self, rng: torch.Generator, n: int, params: Any = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def transition_values(self, state, action, hit_card: torch.Tensor, dealer_cards: torch.Tensor,
                          params: Any = None) -> dict:
        """The step for card indices ``hit_card`` (N,), the player's card on a
        hit, and ``dealer_cards`` (N, DEALER_DRAWS), the dealer's k-th draw in
        column k on a stick."""
        deck = _deck(hit_card.device)
        card = deck[hit_card.long()]
        hit_sum = state["p_sum"] + card
        hit_ace = state["p_ace"] | (card == 1)
        hit_bust = _best(hit_sum, hit_ace)[0] > 21

        d_sum, d_ace = state["d_sum"], state["d_ace"]
        for drawn in deck[dealer_cards.long()].unbind(-1):
            draws = _best(d_sum, d_ace)[0] < 17
            d_sum = torch.where(draws, d_sum + drawn, d_sum)
            d_ace = d_ace | (draws & (drawn == 1))
        payout = torch.sign(_score(state["p_sum"], state["p_ace"]) - _score(d_sum, d_ace)).to(torch.float32)
        if self.sab:
            payout = torch.where(state["p_nat"] & ~state["d_nat"], 1.0, payout)
        elif self.natural:
            payout = torch.where(state["p_nat"] & (payout == 1.0), 1.5, payout)

        hit = action == 1
        return {
            **state,
            "p_sum": torch.where(hit, hit_sum, state["p_sum"]),
            "p_ace": torch.where(hit, hit_ace, state["p_ace"]),
            "d_sum": torch.where(hit, state["d_sum"], d_sum),
            "d_ace": torch.where(hit, state["d_ace"], d_ace),
            "done": torch.where(hit, hit_bust, True),
            "r": torch.where(hit, torch.where(hit_bust, -1.0, 0.0), payout),
        }

    def transition_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` steps: the hit card (n,) and the dealer's cards
        (n, DEALER_DRAWS), used or not."""
        return (
            torch.randint(0, len(DECK), (n,), generator=rng, device=rng.device),
            torch.randint(0, len(DECK), (n, DEALER_DRAWS), generator=rng, device=rng.device),
        )

    def transition(self, state, action, rng: torch.Generator, params: Any = None):
        return self.transition_values(state, action, *self.transition_draws(rng, state["p_sum"].shape[0]), params)

    def observation(self, state, rng, params: Any = None):
        best, usable = _best(state["p_sum"], state["p_ace"])
        return torch.stack((best, state["d_show"], usable.to(torch.int32)), dim=-1)

    def reward(self, state, action, next_state, rng, params: Any = None):
        return next_state["r"]

    def terminal(self, state, rng, params: Any = None):
        return state["done"]

    # -- host-side rgb rendering (reference tabular/blackjack.py draws card
    # sprites via pygame; this raster schematic shows the same state) -------

    def render_init(self, width: int = 240, height: int = 160, **kwargs: Any):
        return {"width": width, "height": height}

    def render_image(self, state, render_state, params: Any = None):
        from gymnasium_tpu_torch.utils.raster import Canvas

        W, H = render_state["width"], render_state["height"]
        canvas = Canvas(W, H, (20, 90, 50))  # table felt
        state = tree_map(lambda leaf: torch.from_numpy(to_host(leaf)), state)
        best, usable = _best(state["p_sum"], state["p_ace"])
        player = int(best)
        dealer = int(state["d_show"])
        ace = bool(usable)
        done = bool(state["done"])

        def bar(x, value, vmax, color):
            h = max(int((H - 40) * min(value, vmax) / vmax), 2)
            canvas.polygon(
                [(x, H - 20 - h), (x + 50, H - 20 - h), (x + 50, H - 20), (x, H - 20)],
                color,
            )

        bar(30, player, 31, (230, 230, 240))  # player hand value
        bar(110, dealer, 11, (240, 200, 90))  # dealer showing card
        if ace:
            canvas.circle((190, 40), 14, (220, 80, 80))  # usable-ace marker
        if done:
            canvas.hline(H - 10, (250, 250, 250), 4)
        return render_state, canvas.rgb_array()

    def render_close(self, render_state) -> None:
        return None


from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv  # noqa: E402


class BlackJackTorchEnv(FunctionalTorchEnv):
    """Stateful Blackjack on ``device`` (JAX's ``BlackJackJaxEnv``)."""

    metadata = {"render_modes": ["rgb_array"], "render_fps": 50, "torch": True}

    def __init__(self, render_mode: str | None = None, device: str | torch.device | None = None, **kwargs: Any):
        super().__init__(
            BlackjackFunctional(kwargs or None),
            metadata=self.metadata,
            render_mode=render_mode,
            device=device,
        )
