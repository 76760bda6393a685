"""Host microseconds an env step spends inside ``mujoco.contact_wrenches``
(every contact-wrench computation: Ant's observation and reward), over the
traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "mujoco.contact_wrenches"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
