"""Host microseconds an env step spends inside ``vector.actions``, the
rollout's action draw (by default ``Box.sample_torch`` and its host
copies), over the traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "vector.actions"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
