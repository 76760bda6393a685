"""Blocking CUDA runtime calls (the names ``host_syncs_per_env_step``
counts) that start inside ``vector.actions``, the rollout's action draw,
over the traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "vector.actions"


def read(trace):
    return spans.calls_per_env_step(trace, SPAN, spans.blocking)
