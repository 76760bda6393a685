"""Blockchain CPD mining game (constructive / parasitic / destructive): the
host env class behind ``make(id)`` (copy of the JAX package's
``envs/blockchain/cpd_env.py``), on the host in numpy float64.

Behavioral parity: reference gymnasium/envs/blockchain/cpd_env.py:31-874
(capability parity only). A round allocates each miner's budget over the
simplex [c, p, d]; utility couples through opponent efficiency:

    U_i = R·α_i·c_i + R·p_i·(mean η_opponents)^β − λ·d_i²

Utilities and efficiency updates are whole-array numpy expressions, the same
code shape as the functional env that ``make_vec`` runs on the card.
"""

from __future__ import annotations

from typing import Any

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces

__all__ = ["BlockchainCPDEnv", "MultiAgentBlockchainCPDEnv"]


def simplex_normalize(action: np.ndarray) -> np.ndarray:
    """Project onto the probability simplex; all-zero falls back to honest."""
    action = np.maximum(np.asarray(action, dtype=np.float64), 0.0)
    total = action.sum(axis=-1, keepdims=True)
    fallback = np.zeros_like(action)
    fallback[..., 0] = 1.0
    with np.errstate(invalid="ignore"):
        normalized = np.where(total < 1e-8, fallback, action / np.where(total < 1e-8, 1.0, total))
    return normalized


def _mean_opponent(values: np.ndarray) -> np.ndarray:
    """Per-miner mean of the other miners' values (vectorized leave-one-out)."""
    n = values.shape[0]
    return (values.sum() - values) / (n - 1)


def compute_utilities(
    all_actions: np.ndarray,
    efficiencies: np.ndarray,
    alpha: np.ndarray,
    base_reward: float,
    beta: float,
    lambda_: float,
) -> np.ndarray:
    """Whole-array CPD utility: constructive + parasitic − destruction cost."""
    c = all_actions[:, 0]
    p = all_actions[:, 1]
    d = all_actions[:, 2]
    mean_eta = _mean_opponent(efficiencies)
    return base_reward * alpha * c + base_reward * p * mean_eta**beta - lambda_ * d**2


def update_efficiencies(
    all_actions: np.ndarray,
    efficiencies: np.ndarray,
    kappa: float,
    eta_recovery: float,
    eta_min: float,
) -> np.ndarray:
    """Degrade each miner by others' destruction, recover, clamp."""
    d = all_actions[:, 2]
    total_destruction = d.sum() - d  # destruction aimed at each miner
    new = efficiencies - kappa * total_destruction + eta_recovery
    return np.clip(new, eta_min, 1.0)


class BlockchainCPDEnv(gym.Env[np.ndarray, np.ndarray]):
    """Single controlled miner vs scripted opponents."""

    metadata = {"render_modes": ["ansi"], "render_fps": 4}

    def __init__(
        self,
        num_miners: int = 2,
        max_rounds: int = 100,
        base_reward: float = 10.0,
        alpha: np.ndarray | list[float] | None = None,
        beta: float = 1.5,
        lambda_: float = 2.0,
        kappa: float = 0.3,
        eta_min: float = 0.1,
        eta_recovery: float = 0.05,
        agent_id: int = 0,
        opponent_policy: str = "honest",
        render_mode: str | None = None,
    ):
        super().__init__()
        assert num_miners >= 2, "Need at least 2 miners for a game"
        assert 0 <= agent_id < num_miners, "agent_id must be in [0, num_miners)"
        assert opponent_policy in ("honest", "random", "tit_for_tat"), (
            f"Unknown opponent policy: {opponent_policy}"
        )

        self.num_miners = num_miners
        self.max_rounds = max_rounds
        self.base_reward = base_reward
        self.beta = beta
        self.lambda_ = lambda_
        self.kappa = kappa
        self.eta_min = eta_min
        self.eta_recovery = eta_recovery
        self.agent_id = agent_id
        self.opponent_policy = opponent_policy
        self.render_mode = render_mode

        if alpha is not None:
            self.alpha = np.array(alpha, dtype=np.float64)
            assert len(self.alpha) == num_miners
            self.alpha = self.alpha / self.alpha.sum()
        else:
            self.alpha = np.ones(num_miners, dtype=np.float64) / num_miners

        self.action_space = spaces.Box(low=0.0, high=1.0, shape=(3,), dtype=np.float64)
        self.obs_dim = 6
        self.observation_space = spaces.Box(
            low=np.array([-np.inf, 0.0, 0.0, 0.0, -np.inf, -np.inf]),
            high=np.array([np.inf, 1.0, 1.0, 1.0, np.inf, np.inf]),
            shape=(self.obs_dim,),
            dtype=np.float64,
        )

        self._cumulative_rewards: np.ndarray | None = None
        self._efficiencies: np.ndarray | None = None
        self._current_round: int = 0
        self._last_reward: float = 0.0
        self._prev_opponent_eta: float = 1.0
        self._last_actions: np.ndarray | None = None
        self._history: list[dict] = []

    # -- API ---------------------------------------------------------------

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        if options and "alpha" in options:
            self.alpha = np.array(options["alpha"], dtype=np.float64)
            self.alpha = self.alpha / self.alpha.sum()

        self._cumulative_rewards = np.zeros(self.num_miners, dtype=np.float64)
        self._efficiencies = np.ones(self.num_miners, dtype=np.float64)
        self._current_round = 0
        self._last_reward = 0.0
        self._prev_opponent_eta = 1.0
        self._last_actions = np.zeros((self.num_miners, 3), dtype=np.float64)
        self._last_actions[:, 0] = 1.0
        self._history = []
        return self._get_obs(), self._get_info()

    def step(self, action: np.ndarray):
        assert self._cumulative_rewards is not None, "Call reset() before step()"

        agent_action = simplex_normalize(np.array(action, dtype=np.float64))
        all_actions = self._generate_all_actions(agent_action)
        rewards = compute_utilities(
            all_actions, self._efficiencies, self.alpha, self.base_reward, self.beta, self.lambda_
        )
        prev_efficiencies = self._efficiencies.copy()
        self._efficiencies = update_efficiencies(
            all_actions, self._efficiencies, self.kappa, self.eta_recovery, self.eta_min
        )

        self._cumulative_rewards += rewards
        self._current_round += 1
        agent_reward = float(rewards[self.agent_id])
        self._last_reward = agent_reward
        opponent_mask = np.arange(self.num_miners) != self.agent_id
        self._prev_opponent_eta = float(prev_efficiencies[opponent_mask].mean())
        self._last_actions = all_actions.copy()

        round_record = {
            "round": self._current_round,
            "actions": all_actions.copy(),
            "rewards": rewards.copy(),
            "efficiencies": self._efficiencies.copy(),
            "cumulative_rewards": self._cumulative_rewards.copy(),
        }
        self._history.append(round_record)

        terminated = self._current_round >= self.max_rounds
        info = self._get_info()
        info["round_record"] = round_record
        return self._get_obs(), agent_reward, terminated, False, info

    def render(self) -> str | None:
        if self.render_mode == "ansi":
            return self._render_ansi()
        return None

    # -- internals ---------------------------------------------------------

    def _generate_all_actions(self, agent_action: np.ndarray) -> np.ndarray:
        all_actions = np.zeros((self.num_miners, 3), dtype=np.float64)
        all_actions[self.agent_id] = agent_action
        for i in range(self.num_miners):
            if i != self.agent_id:
                all_actions[i] = self._get_opponent_action(i)
        return all_actions

    def _get_opponent_action(self, miner_id: int) -> np.ndarray:
        if self.opponent_policy == "honest":
            return np.array([1.0, 0.0, 0.0], dtype=np.float64)
        if self.opponent_policy == "random":
            return self.np_random.dirichlet(np.ones(3)).astype(np.float64)
        if self.opponent_policy == "tit_for_tat":
            if self._last_actions is not None:
                return self._last_actions[self.agent_id].copy()
            return np.array([1.0, 0.0, 0.0], dtype=np.float64)
        return np.array([1.0, 0.0, 0.0], dtype=np.float64)

    def _get_obs(self) -> np.ndarray:
        cum_reward = (
            self._cumulative_rewards[self.agent_id]
            if self._cumulative_rewards is not None
            else 0.0
        )
        if self._efficiencies is not None:
            opp_mask = np.arange(self.num_miners) != self.agent_id
            mean_opp_eta = float(self._efficiencies[opp_mask].mean())
        else:
            mean_opp_eta = 1.0
        return np.array(
            [
                cum_reward,
                mean_opp_eta,
                float(self.alpha[self.agent_id]),
                self._current_round / max(self.max_rounds, 1),
                self._last_reward,
                mean_opp_eta - self._prev_opponent_eta,
            ],
            dtype=np.float64,
        )

    def _get_info(self) -> dict[str, Any]:
        return {
            "current_round": self._current_round,
            "efficiencies": None if self._efficiencies is None else self._efficiencies.copy(),
            "cumulative_rewards": (
                None if self._cumulative_rewards is None else self._cumulative_rewards.copy()
            ),
            "alpha": self.alpha.copy(),
            "history_length": len(self._history),
        }

    def _render_ansi(self) -> str:
        lines = [f"Round {self._current_round}/{self.max_rounds}"]
        for i in range(self.num_miners):
            tag = "*" if i == self.agent_id else " "
            lines.append(
                f" {tag}miner {i}: alpha={self.alpha[i]:.2f}, "
                f"eta={self._efficiencies[i]:.3f}, "
                f"cum_reward={self._cumulative_rewards[i]:.2f}"
            )
        return "\n".join(lines) + "\n"

    def get_history(self) -> list[dict]:
        """Full per-round history records."""
        return self._history

    def get_last_n_rounds(self, n: int) -> list[dict]:
        """The most recent ``n`` round records."""
        return self._history[-n:]


class MultiAgentBlockchainCPDEnv:
    """All miners externally controlled (not registered; parity with the
    reference's non-registered multi-agent variant, cpd_env.py:526)."""

    def __init__(
        self,
        num_miners: int = 2,
        max_rounds: int = 100,
        base_reward: float = 10.0,
        alpha: np.ndarray | list[float] | None = None,
        beta: float = 1.5,
        lambda_: float = 2.0,
        kappa: float = 0.3,
        eta_min: float = 0.1,
        eta_recovery: float = 0.05,
    ):
        assert num_miners >= 2
        self.num_miners = num_miners
        self.max_rounds = max_rounds
        self.base_reward = base_reward
        self.beta = beta
        self.lambda_ = lambda_
        self.kappa = kappa
        self.eta_min = eta_min
        self.eta_recovery = eta_recovery

        if alpha is not None:
            agent_alpha = np.array(alpha, dtype=np.float64)
            agent_alpha = agent_alpha / agent_alpha.sum()
        else:
            agent_alpha = np.ones(num_miners, dtype=np.float64) / num_miners
        self.alpha = agent_alpha.copy()

        self.action_space = spaces.Box(low=0.0, high=1.0, shape=(3,), dtype=np.float64)
        self.observation_space = spaces.Box(
            low=np.array([-np.inf, 0.0, 0.0, 0.0, -np.inf, -np.inf]),
            high=np.array([np.inf, 1.0, 1.0, 1.0, np.inf, np.inf]),
            shape=(6,),
            dtype=np.float64,
        )

        self._cumulative_rewards: np.ndarray | None = None
        self._efficiencies: np.ndarray | None = None
        self._prev_efficiencies: np.ndarray | None = None
        self._last_rewards: np.ndarray | None = None
        self._current_round = 0
        self._history: list[dict] = []

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        """Reset; returns per-agent observations and infos."""
        self._cumulative_rewards = np.zeros(self.num_miners, dtype=np.float64)
        self._efficiencies = np.ones(self.num_miners, dtype=np.float64)
        self._prev_efficiencies = np.ones(self.num_miners, dtype=np.float64)
        self._last_rewards = np.zeros(self.num_miners, dtype=np.float64)
        self._current_round = 0
        self._history = []
        obs = [self._get_obs(i) for i in range(self.num_miners)]
        infos = [self._get_info(i) for i in range(self.num_miners)]
        return obs, infos

    def step(self, actions: np.ndarray | list):
        """Advance one round with an action per miner."""
        assert self._cumulative_rewards is not None, "Call reset() before step()"
        all_actions = simplex_normalize(np.asarray(actions, dtype=np.float64))
        assert all_actions.shape == (self.num_miners, 3)

        rewards = compute_utilities(
            all_actions, self._efficiencies, self.alpha, self.base_reward, self.beta, self.lambda_
        )
        self._prev_efficiencies = self._efficiencies.copy()
        self._efficiencies = update_efficiencies(
            all_actions, self._efficiencies, self.kappa, self.eta_recovery, self.eta_min
        )
        self._cumulative_rewards += rewards
        self._last_rewards = rewards
        self._current_round += 1

        self._history.append(
            {
                "round": self._current_round,
                "actions": all_actions.copy(),
                "rewards": rewards.copy(),
                "efficiencies": self._efficiencies.copy(),
                "cumulative_rewards": self._cumulative_rewards.copy(),
            }
        )

        terminated = self._current_round >= self.max_rounds
        obs = [self._get_obs(i) for i in range(self.num_miners)]
        infos = [self._get_info(i) for i in range(self.num_miners)]
        return obs, rewards.tolist(), terminated, False, infos

    def _get_obs(self, agent_id: int) -> np.ndarray:
        opp_mask = np.arange(self.num_miners) != agent_id
        mean_opp_eta = float(self._efficiencies[opp_mask].mean())
        prev_opp_eta = float(self._prev_efficiencies[opp_mask].mean())
        return np.array(
            [
                self._cumulative_rewards[agent_id],
                mean_opp_eta,
                float(self.alpha[agent_id]),
                self._current_round / max(self.max_rounds, 1),
                float(self._last_rewards[agent_id]),
                mean_opp_eta - prev_opp_eta,
            ],
            dtype=np.float64,
        )

    def _get_info(self, agent_id: int) -> dict[str, Any]:
        return {
            "agent_id": agent_id,
            "current_round": self._current_round,
            "efficiencies": self._efficiencies.copy(),
            "cumulative_rewards": self._cumulative_rewards.copy(),
            "alpha": self.alpha.copy(),
        }

    def get_history(self) -> list[dict]:
        """Full per-round history records."""
        return self._history
