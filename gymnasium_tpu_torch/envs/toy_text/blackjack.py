"""Blackjack with an infinite deck: the host env class (copy of the JAX
package's ``envs/toy_text/blackjack.py``), on the host in numpy.

Behavioral parity: reference toy_text/blackjack.py:163-240, including the
RNG-stream-affecting cosmetic draws in ``reset`` (card suit and face-card
name for rendering).
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces

__all__ = ["BlackjackEnv"]

DECK = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 10, 10, 10]


def cmp(a, b):
    """+1/0/-1 comparison used for the final payout."""
    return float(a > b) - float(a < b)


def draw_card(np_random):
    """One card from the infinite deck."""
    return int(np_random.choice(DECK))


def draw_hand(np_random):
    """A starting two-card hand."""
    return [draw_card(np_random), draw_card(np_random)]


def usable_ace(hand):
    """Whether the hand holds an ace countable as 11 without busting."""
    return 1 in hand and sum(hand) + 10 <= 21


def sum_hand(hand):
    """Best total of the hand (ace as 11 when usable)."""
    if usable_ace(hand):
        return sum(hand) + 10
    return sum(hand)


def is_bust(hand):
    """Hand total exceeds 21."""
    return sum_hand(hand) > 21


def score(hand):
    """Final score: hand total, or 0 when bust."""
    return 0 if is_bust(hand) else sum_hand(hand)


def is_natural(hand):
    """Two-card 21."""
    return sorted(hand) == [1, 10]


class BlackjackEnv(gym.Env):
    """Beat the dealer without going over 21 (infinite deck)."""

    metadata = {"render_modes": ["human", "rgb_array"], "render_fps": 4}

    def __init__(self, render_mode: str | None = None, natural: bool = False, sab: bool = False):
        self.action_space = spaces.Discrete(2)
        self.observation_space = spaces.Tuple(
            (spaces.Discrete(32), spaces.Discrete(11), spaces.Discrete(2))
        )
        # payout 1.5x on a natural win (casino rules)
        self.natural = natural
        # strict Sutton & Barto rules; overrides `natural`
        self.sab = sab
        self.render_mode = render_mode
        self._display = None

    def step(self, action):
        assert self.action_space.contains(action)
        if action:  # hit
            self.player.append(draw_card(self.np_random))
            if is_bust(self.player):
                terminated = True
                reward = -1.0
            else:
                terminated = False
                reward = 0.0
        else:  # stick: dealer plays out
            terminated = True
            while sum_hand(self.dealer) < 17:
                self.dealer.append(draw_card(self.np_random))
            reward = cmp(score(self.player), score(self.dealer))
            if self.sab and is_natural(self.player) and not is_natural(self.dealer):
                reward = 1.0
            elif (
                not self.sab and self.natural and is_natural(self.player) and reward == 1.0
            ):
                reward = 1.5

        if self.render_mode == "human":
            self.render()
        return self._get_obs(), reward, terminated, False, {}

    def _get_obs(self):
        s = sum(self.player)
        if 1 in self.player and s + 10 <= 21:
            return (s + 10, self.dealer[0], 1)
        return (s, self.dealer[0], 0)

    def reset(self, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        self.dealer = draw_hand(self.np_random)
        self.player = draw_hand(self.np_random)

        _, dealer_card_value, _ = self._get_obs()

        # Cosmetic draws — kept because they consume the RNG stream the same
        # way the reference does (parity of subsequent trajectories).
        suits = ["C", "D", "H", "S"]
        self.dealer_top_card_suit = self.np_random.choice(suits)
        if dealer_card_value == 1:
            self.dealer_top_card_value_str = "A"
        elif dealer_card_value == 10:
            self.dealer_top_card_value_str = self.np_random.choice(["J", "Q", "K"])
        else:
            self.dealer_top_card_value_str = str(dealer_card_value)

        if self.render_mode == "human":
            self.render()
        return self._get_obs(), {}

    def render(self):
        if self.render_mode is None:
            gym.logger.warn(
                "You are calling render method without specifying any render mode."
            )
            return None
        from gymnasium_tpu_torch.utils.raster import Canvas

        canvas = Canvas(600, 500, (7, 99, 36))
        player_sum, dealer_card, usable = self._get_obs()
        # dealer card
        canvas.polygon([(130, 60), (230, 60), (230, 200), (130, 200)], (255, 255, 255))
        # hidden card
        canvas.polygon([(250, 60), (350, 60), (350, 200), (250, 200)], (120, 30, 30))
        # simple card-count pips for player total
        for i in range(min(int(player_sum), 27)):
            canvas.circle((60 + (i % 9) * 55, 320 + (i // 9) * 55), 16, (255, 255, 255))
        frame = canvas.rgb_array()
        if self.render_mode == "human":
            if self._display is None:
                from gymnasium_tpu_torch.utils.human_display import HumanDisplay

                self._display = HumanDisplay(600, 500, self.metadata["render_fps"], "Blackjack")
            self._display.show(frame)
            return None
        return frame

    def close(self):
        if self._display is not None:
            self._display.close()
            self._display = None
