"""Host microseconds an env step spends inside ``mujoco.com_velocity`` (the
bodies' centre-of-mass velocities of Humanoid's observation), over the
traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "mujoco.com_velocity"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
