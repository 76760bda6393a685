"""Toy-text sampling helper (copy of the JAX package's ``envs/toy_text/utils.py``;
reference gymnasium/envs/toy_text/utils.py:4)."""

from __future__ import annotations

import numpy as np


def categorical_sample(prob_n, np_random: np.random.Generator):
    """Sample an index from class probabilities via cumsum-compare.

    Consumes exactly one uniform draw — the parity suite depends on this
    matching the reference's RNG stream consumption.
    """
    prob_n = np.asarray(prob_n)
    csprob_n = np.cumsum(prob_n)
    return np.argmax(csprob_n > np_random.random())
