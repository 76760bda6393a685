"""Host microseconds an env step spends inside ``mujoco.mass_center`` (the
whole robot's centre of mass along x, twice in Humanoid's reward), over the
traced window's env steps of the whole batch."""

from portbench import spans

SPAN = "mujoco.mass_center"


def read(trace):
    return spans.per_env_step_us(trace, SPAN)
