"""Host milliseconds a train step spends inside the trainer's
``ppo.advantages`` ranges (the value pass, GAE and the advantages'
normalisation), summed, averaged over the traced train steps."""

from portbench import spans

SPAN = "ppo.advantages"


def read(trace):
    return spans.per_unit_ms(trace, SPAN)
