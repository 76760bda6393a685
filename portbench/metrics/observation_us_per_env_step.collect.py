"""Host microseconds an env step spends inside ``func.observation`` (for
Ant, one contact-wrench call), over the traced window's env steps of the
whole batch."""

from portbench import spans

SPAN = "func.observation"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
