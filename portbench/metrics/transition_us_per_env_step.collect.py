"""Host microseconds an env step spends inside ``func.transition``, the
functional step's transition (the articulated kernel's launch), over the
traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "func.transition"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
