"""Generic tabular MDP as a batch-first functional env.

Counterpart of ``TabularFuncEnv`` in the JAX package's ``envs/tabular/core.py``.
State is a dict of ``s`` (N,) int32, the state index, and ``r`` (N,)
float32 and ``t`` (N,) bool, the reward and termination of the transition
into it, so the reward and terminal hooks read them back. A step gathers the
rows of the ``(s·A + a, K)`` tables and picks a branch by the Gumbel-max
trick, ``argmax(log(p + 1e-30) + g)`` in float32, which is what
``jax.random.categorical`` computes: given the same Gumbel draws, both pick
the same branch. (The JAX env contracts one-hot rows on the MXU instead,
because dynamic gathers serialise on a TPU; a gather is exact and cheap on a
GPU.) Models whose every branch 0 has probability 1 take it without a draw.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.toy_text.tabular_core import TabularModel
from gymnasium_tpu_torch.functional import FuncEnv
from gymnasium_tpu_torch.utils.draws import gumbel

__all__ = ["TabularFuncEnv"]


def _logits(probs: np.ndarray) -> np.ndarray:
    """``log(p + 1e-30)`` in float32, the JAX env's logits."""
    return np.log(probs.astype(np.float32) + np.float32(1e-30))


class TabularFuncEnv(FuncEnv):
    """Stateless tabular MDP over dense ``[S, A, K]`` transition tensors."""

    def __init__(self, model: TabularModel, options: dict[str, Any] | None = None):
        super().__init__(options)
        self.model = model
        self._deterministic = bool(np.all(np.max(model.probs, axis=-1) >= 1.0))
        s_count, a_count, k_count = model.next_state.shape
        self._k = k_count
        self._tables_np = {
            "initial_logits": _logits(model.initial_probs),
            "logits": _logits(model.probs).reshape(s_count * a_count, k_count),
            "next_state": model.next_state.astype(np.int32).reshape(s_count * a_count, k_count),
            "reward": model.reward.astype(np.float32).reshape(s_count * a_count, k_count),
            "terminated": model.terminated.reshape(s_count * a_count, k_count),
        }
        self._tables_on: dict[torch.device, dict[str, torch.Tensor]] = {}
        self.observation_space = spaces.Discrete(model.num_states)
        self.action_space = spaces.Discrete(model.num_actions)

    def _tables(self, device: torch.device) -> dict[str, torch.Tensor]:
        """The model's tables on ``device``, copied there once."""
        tables = self._tables_on.get(device)
        if tables is None:
            tables = self._tables_on[device] = {
                k: torch.from_numpy(v).to(device) for k, v in self._tables_np.items()
            }
        return tables

    def reset_values(self, g: torch.Tensor, params: Any = None) -> dict:
        """The reset state of Gumbel draws ``g`` (N, S): the Gumbel-max pick
        from the initial distribution."""
        s = torch.argmax(self._tables(g.device)["initial_logits"] + g, dim=-1).to(torch.int32)
        return {
            "s": s,
            "r": torch.zeros(s.shape, dtype=torch.float32, device=g.device),
            "t": torch.zeros(s.shape, dtype=torch.bool, device=g.device),
        }

    def initial(self, rng: torch.Generator, params: Any = None):
        return {k: v[0] for k, v in self.initial_batched(rng, 1, params).items()}

    def reset_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` resets: Gumbel (n, S)."""
        return (gumbel(rng, (n, self.model.num_states), rng.device),)

    def initial_batched(self, rng: torch.Generator, n: int, params: Any = None):
        return self.reset_values(*self.reset_draws(rng, n), params)

    def transition_values(self, state, action, g: torch.Tensor | None, params: Any = None) -> dict:
        """The transition for Gumbel draws ``g`` (N, K); ``None`` on a model
        whose every branch 0 is certain, where no draw is taken."""
        tables = self._tables(state["s"].device)
        row = state["s"].long() * self.model.num_actions + action.long()
        if self._deterministic:
            k = torch.zeros_like(row)
        else:
            k = torch.argmax(tables["logits"][row] + g, dim=-1)
        return {
            "s": tables["next_state"][row, k],
            "r": tables["reward"][row, k],
            "t": tables["terminated"][row, k],
        }

    def transition_draws(self, rng: torch.Generator, n: int) -> tuple:
        """The draws of ``n`` transitions: Gumbel (n, K), or None on a model
        that takes no draw."""
        return (None if self._deterministic else gumbel(rng, (n, self._k), rng.device),)

    def transition(self, state, action, rng: torch.Generator, params: Any = None):
        return self.transition_values(state, action, *self.transition_draws(rng, state["s"].shape[0]), params)

    def observation(self, state, rng, params: Any = None):
        return state["s"]

    def reward(self, state, action, next_state, rng, params: Any = None):
        return next_state["r"]

    def terminal(self, state, rng, params: Any = None):
        return state["t"]
