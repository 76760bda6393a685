"""Kernel-launch runtime calls (``cudaLaunch*``, ``cuLaunch*``) that start
inside ``mujoco.mass_center``, over the traced window's env steps of the
whole batch."""

from portbench import spans

SPAN = "mujoco.mass_center"


def read(trace):
    return spans.calls_per_env_step(trace, SPAN, spans.launch)
