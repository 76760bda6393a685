"""Kernel-launch runtime calls (``cudaLaunch*``, ``cuLaunch*``) that start
inside ``mujoco.com_velocity``, over the traced window's env steps of the
whole batch."""

from portbench import spans

SPAN = "mujoco.com_velocity"


def read(trace):
    return spans.calls_per_env_step(trace, SPAN, spans.launch)
