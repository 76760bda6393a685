"""Host microseconds an env step spends inside ``func.reset``, the reset
drawn for the whole batch and selected lane by lane, over the traced
window's env steps of the whole batch."""

from portbench import spans

SPAN = "func.reset"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
