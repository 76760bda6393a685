"""Share of the traced window's device idle time not put down to a leaf
span: a gap counts as unattributed when, at its middle, no program span
runs or the innermost one is a container, whose self time names no layer."""

from portbench import spans

CONTAINERS = ("vector.rollout", "vector.step", "ppo.rollout", "ppo.env_step", "ppo.update")


def read(trace):
    return spans.unattributed_idle_pct(trace, CONTAINERS)
