"""The blockchain CPD game as a batch-first functional env.

Counterpart of ``BlockchainCPDFunctional`` in the JAX package's
``envs/blockchain/cpd_functional.py``, which is written for one game and
vmapped: here every leaf has a leading game axis, so ``eta`` and ``cum`` are
(N, M) for M miners. Each round every miner splits its effort over
cooperate, profit and destroy; the controlled miner's split is the action,
the others follow the opponent policy. The spaces are declared float64, as
in JAX, and the values are float32, as JAX computes them.
"""

from __future__ import annotations

import functools
from typing import Any, NamedTuple

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.functional import FuncEnv

__all__ = ["BlockchainCPDFunctional", "CPDParams"]

_HONEST = (1.0, 0.0, 0.0)


class CPDParams(NamedTuple):
    """CPD game constants; ``alpha`` is the miners' hash-power shares, a
    tuple of floats (float32 values) summing to 1."""

    base_reward: Any = 10.0
    beta: Any = 1.5
    lambda_: Any = 2.0
    kappa: Any = 0.3
    eta_min: Any = 0.1
    eta_recovery: Any = 0.05
    alpha: Any = None


@functools.lru_cache(maxsize=32)
def _vector(values: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def _simplex_normalize(action: torch.Tensor) -> torch.Tensor:
    """Non-negative parts over their sum; ``[1, 0, 0]`` where they sum below 1e-8."""
    action = torch.clamp_min(action, 0.0)
    total = action.sum(dim=-1, keepdim=True)
    small = total < 1e-8
    fallback = _vector(_HONEST, action.device).expand_as(action)
    return torch.where(small, fallback, action / torch.where(small, 1.0, total))


class BlockchainCPDFunctional(FuncEnv):
    """Stateless CPD game: one controlled miner against scripted opponents.

    Options: ``num_miners`` (M, 2), ``max_rounds`` (100), ``agent_id`` (0),
    ``opponent_policy`` (``"honest"``, ``"random"`` or ``"tit_for_tat"``),
    and any :class:`CPDParams` field as a default. State: ``eta`` and
    ``cum`` (N, M), ``prev_opp_eta`` and ``last_reward`` (N,) float32,
    ``last_agent_action`` (N, 3) float32, ``round`` (N,) int32.
    """

    def __init__(self, options: dict[str, Any] | None = None):
        options = dict(options or {})
        self.num_miners = int(options.pop("num_miners", 2))
        self.max_rounds = int(options.pop("max_rounds", 100))
        self.agent_id = int(options.pop("agent_id", 0))
        self.opponent_policy = options.pop("opponent_policy", "honest")
        if self.opponent_policy not in ("honest", "random", "tit_for_tat"):
            raise ValueError(f"unknown opponent_policy {self.opponent_policy!r}")
        self._base_kwargs = options
        super().__init__(None)
        self.action_space = spaces.Box(low=0.0, high=1.0, shape=(3,), dtype=np.float64)
        self.observation_space = spaces.Box(
            low=np.array([-np.inf, 0.0, 0.0, 0.0, -np.inf, -np.inf]),
            high=np.array([np.inf, 1.0, 1.0, 1.0, np.inf, np.inf]),
            shape=(6,),
            dtype=np.float64,
        )

    def get_default_params(self, **kwargs: Any) -> CPDParams:
        merged = {**self._base_kwargs, **kwargs}
        alpha = merged.pop("alpha", None)
        if alpha is None:
            alpha = np.ones(self.num_miners, np.float32) / np.float32(self.num_miners)
        else:
            alpha = np.asarray(alpha, np.float32)
            alpha = alpha / alpha.sum()
        return CPDParams(alpha=tuple(float(a) for a in alpha), **merged)

    def initial(self, rng: torch.Generator, params: CPDParams | None = None):
        return {k: v[0] for k, v in self.initial_batched(rng, 1, params).items()}

    def initial_batched(self, rng: torch.Generator, n: int, params: CPDParams | None = None):
        """The fixed opening state of every game, on the generator's device."""
        m, f32 = self.num_miners, dict(dtype=torch.float32, device=rng.device)
        return {
            "eta": torch.ones((n, m), **f32),
            "prev_opp_eta": torch.ones((n,), **f32),
            "cum": torch.zeros((n, m), **f32),
            "last_reward": torch.zeros((n,), **f32),
            "last_agent_action": _vector(_HONEST, rng.device).expand(n, 3).clone(),
            "round": torch.zeros((n,), dtype=torch.int32, device=rng.device),
        }

    def _opponent_mask(self, device: torch.device) -> torch.Tensor:
        return torch.arange(self.num_miners, device=device) != self.agent_id

    def transition_values(self, state, action, opponents: torch.Tensor | None = None,
                          params: CPDParams | None = None) -> dict:
        """The round for the opponents' splits ``opponents`` (N, M, 3), the
        Dirichlet(1, 1, 1) draws of the ``"random"`` policy (the other
        policies take none)."""
        params = params or self.get_default_params()
        eta = state["eta"]
        n, m, device = eta.shape[0], self.num_miners, eta.device
        agent_action = _simplex_normalize(action.to(torch.float32))
        if self.opponent_policy == "honest":
            opponents = _vector(_HONEST, device).expand(n, m, 3)
        elif self.opponent_policy == "tit_for_tat":
            opponents = state["last_agent_action"][:, None, :].expand(n, m, 3)
        is_agent = ~self._opponent_mask(device)
        all_actions = torch.where(is_agent[None, :, None], agent_action[:, None, :], opponents)
        c, p, d = all_actions.unbind(-1)

        mean_eta = (eta.sum(dim=-1, keepdim=True) - eta) / (m - 1)
        rewards = (
            params.base_reward * _vector(params.alpha, device) * c
            + params.base_reward * p * mean_eta**params.beta
            - params.lambda_ * d**2
        )
        total_destruction = d.sum(dim=-1, keepdim=True) - d
        new_eta = torch.clamp(eta - params.kappa * total_destruction + params.eta_recovery, params.eta_min, 1.0)
        prev_opp_eta = torch.where(self._opponent_mask(device), eta, 0.0).sum(dim=-1) / (m - 1)
        return {
            "eta": new_eta,
            "prev_opp_eta": prev_opp_eta,
            "cum": state["cum"] + rewards,
            "last_reward": rewards[:, self.agent_id],
            "last_agent_action": agent_action,
            "round": state["round"] + 1,
        }

    def transition_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` rounds: the random opponents' splits (n, M, 3),
        Dirichlet(1, 1, 1) as three Exp(1) draws over their sum; None for the
        other policies."""
        if self.opponent_policy != "random":
            return (None,)
        e = torch.empty((n, self.num_miners, 3), device=rng.device).exponential_(generator=rng)
        return (e / e.sum(dim=-1, keepdim=True),)

    def transition(self, state, action, rng: torch.Generator, params: CPDParams | None = None):
        return self.transition_values(state, action, *self.transition_draws(rng, state["eta"].shape[0]), params)

    def observation(self, state, rng, params: CPDParams | None = None):
        params = params or self.get_default_params()
        eta = state["eta"]
        mean_opp_eta = torch.where(self._opponent_mask(eta.device), eta, 0.0).sum(dim=-1) / (self.num_miners - 1)
        return torch.stack(
            (
                state["cum"][:, self.agent_id],
                mean_opp_eta,
                torch.full_like(mean_opp_eta, params.alpha[self.agent_id]),
                state["round"].to(torch.float32) / max(self.max_rounds, 1),
                state["last_reward"],
                mean_opp_eta - state["prev_opp_eta"],
            ),
            dim=-1,
        )

    def reward(self, state, action, next_state, rng, params: CPDParams | None = None):
        return next_state["last_reward"]

    def terminal(self, state, rng, params: CPDParams | None = None):
        return state["round"] >= self.max_rounds
