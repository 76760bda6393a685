"""Host milliseconds a train step spends inside the trainer's ``ppo.backward``
ranges (the minibatches' backward passes), summed, averaged over the traced
train steps."""

from portbench import spans

SPAN = "ppo.backward"


def read(trace):
    return spans.per_unit_ms(trace, SPAN)
