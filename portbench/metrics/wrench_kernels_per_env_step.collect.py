"""Kernel-launch runtime calls (``cudaLaunch*``, ``cuLaunch*``) that start
inside ``mujoco.contact_wrenches``, over the traced window's env steps of
the whole batch."""

from portbench import spans

SPAN = "mujoco.contact_wrenches"


def read(trace):
    return spans.calls_per_env_step(trace, SPAN, spans.launch)
