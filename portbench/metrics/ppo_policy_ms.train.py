"""Host milliseconds a train step spends inside the trainer's ``ppo.policy``
ranges (the policy's forward pass, the action noise and the
log-probability), summed, averaged over the traced train steps."""

from portbench import spans

SPAN = "ppo.policy"


def read(trace):
    return spans.per_unit_ms(trace, SPAN)
