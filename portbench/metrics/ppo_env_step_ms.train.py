"""Host milliseconds a train step spends inside the trainer's ``ppo.env_step``
ranges (the wrapped autoreset env step), summed, averaged over the traced
train steps."""

from portbench import spans

SPAN = "ppo.env_step"


def read(trace):
    return spans.per_unit_ms(trace, SPAN)
