"""Dense tabular MDP model and its host env (own copy of the JAX package's
``envs/toy_text/tabular_core.py``).

The reference stores transitions as ``P[s][a] = [(prob, s', r, term), ...]``
dicts. Here the same MDP is a set of dense ``[S, A, K]`` numpy tensors, which
:class:`~gymnasium_tpu_torch.envs.tabular.core.TabularFuncEnv` steps with
gathers and a categorical draw on the card, and :class:`TabularHostEnv`
samples on the host in the reference's order, so its trajectories stay
bit-exact with the reference.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.toy_text.utils import categorical_sample

__all__ = ["TabularModel", "TabularHostEnv", "model_from_P"]


class TabularModel(NamedTuple):
    """Dense MDP: ``[S, A, K]`` transition tensors + initial distribution.

    ``K`` is the max branching factor; unused branches carry zero
    probability (and self-loop next-states so gathers stay in range).
    """

    probs: np.ndarray  # [S, A, K] float64
    next_state: np.ndarray  # [S, A, K] int32
    reward: np.ndarray  # [S, A, K] float64
    terminated: np.ndarray  # [S, A, K] bool
    initial_probs: np.ndarray  # [S] float64

    @property
    def num_states(self) -> int:
        return self.probs.shape[0]

    @property
    def num_actions(self) -> int:
        return self.probs.shape[1]


def model_from_P(P: dict, initial_probs: np.ndarray) -> TabularModel:
    """Build the dense model from a reference-style ``P[s][a]`` dict."""
    S = len(P)
    A = len(P[0])
    K = max(len(P[s][a]) for s in P for a in P[s])
    probs = np.zeros((S, A, K), dtype=np.float64)
    next_state = np.zeros((S, A, K), dtype=np.int32)
    reward = np.zeros((S, A, K), dtype=np.float64)
    term = np.zeros((S, A, K), dtype=bool)
    for s in range(S):
        for a in range(A):
            for k, (p, ns, r, t) in enumerate(P[s][a]):
                probs[s, a, k] = p
                next_state[s, a, k] = ns
                reward[s, a, k] = r
                term[s, a, k] = t
            for k in range(len(P[s][a]), K):
                next_state[s, a, k] = s
    return TabularModel(probs, next_state, reward, term, np.asarray(initial_probs, np.float64))


class TabularHostEnv(gym.Env[int, int]):
    """Stateful host shell over a :class:`TabularModel`.

    Subclasses provide the model, rendering, and any info extras; stepping
    semantics (including RNG stream consumption) match the reference's
    ``categorical_sample`` envs exactly.
    """

    model: TabularModel

    def __init__(self, model: TabularModel, render_mode: str | None = None):
        self.model = model
        self.observation_space = spaces.Discrete(model.num_states)
        self.action_space = spaces.Discrete(model.num_actions)
        self.render_mode = render_mode
        self.s: int = 0
        self.lastaction: int | None = None

    # P-dict view for reference-API compatibility (built lazily).
    @property
    def P(self) -> dict:
        if not hasattr(self, "_P_cache"):
            m = self.model
            self._P_cache = {
                s: {
                    a: [
                        (m.probs[s, a, k], int(m.next_state[s, a, k]), m.reward[s, a, k], bool(m.terminated[s, a, k]))
                        for k in range(m.probs.shape[2])
                        if m.probs[s, a, k] > 0
                    ]
                    for a in range(m.num_actions)
                }
                for s in range(m.num_states)
            }
        return self._P_cache

    @property
    def initial_state_distrib(self) -> np.ndarray:
        return self.model.initial_probs

    def _sample_transition(self, a):
        m = self.model
        k = categorical_sample(m.probs[self.s, a], self.np_random)
        return (
            m.probs[self.s, a, k],
            int(m.next_state[self.s, a, k]),
            m.reward[self.s, a, k],
            bool(m.terminated[self.s, a, k]),
        )

    def step(self, a):
        p, s, r, t = self._sample_transition(a)
        self.s = s
        self.lastaction = a
        if self.render_mode == "human":
            self.render()
        return int(s), r, t, False, {"prob": p}

    def reset(self, *, seed: int | None = None, options: dict[str, Any] | None = None):
        super().reset(seed=seed)
        self.s = int(categorical_sample(self.model.initial_probs, self.np_random))
        self.lastaction = None
        if self.render_mode == "human":
            self.render()
        return int(self.s), {"prob": 1}
