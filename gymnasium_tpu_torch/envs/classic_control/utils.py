"""Reset-bound parsing helpers (copy of the JAX package's
``envs/classic_control/utils.py``; reference envs/classic_control/utils.py)."""

from __future__ import annotations

from typing import Any

import numpy as np

from gymnasium_tpu_torch import error


def verify_number_and_cast(x: Any) -> float:
    """Verify that ``x`` is a scalar number and cast it to float."""
    try:
        x = float(x)
    except (ValueError, TypeError):
        raise ValueError(f"An option ({x}) could not be converted to a float.")
    return x


def maybe_parse_reset_bounds(
    options: dict | None, default_low: float, default_high: float
) -> tuple[float, float]:
    """Extract ``low``/``high`` reset bounds from reset ``options``."""
    if options is None:
        return default_low, default_high
    low = options.get("low") if "low" in options else default_low
    high = options.get("high") if "high" in options else default_high
    low = verify_number_and_cast(low)
    high = verify_number_and_cast(high)
    if low > high:
        raise ValueError(
            f"Lower bound ({low}) must be lower than higher bound ({high})."
        )
    return low, high
