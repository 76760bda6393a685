"""Dense tabular MDP model (own copy of the JAX package's ``envs/toy_text/tabular_core.py``).

The reference stores transitions as ``P[s][a] = [(prob, s', r, term), ...]``
dicts. Here the same MDP is a set of dense ``[S, A, K]`` numpy tensors, which
:class:`~gymnasium_tpu_torch.envs.tabular.core.TabularFuncEnv` steps with
gathers and a categorical draw. The host shell over the model is not ported.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

__all__ = ["TabularModel", "model_from_P"]


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
