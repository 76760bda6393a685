"""The planted faults of :mod:`portbench.faults`, with ``altered`` reaching
Humanoid's reward too.

``faults.plant("altered", ...)`` patches the reward hooks of HalfCheetah and
Ant by name; Humanoid's reward is a hook of its own class, which it leaves
as it is. :func:`plant` here plants the same alteration there as well (the
reward adds the control cost where the task subtracts it); ``unchanged``
and ``half`` patch the step every MuJoCo-class robot shares and need
nothing more. To calibrate a Humanoid cell's limits with it, on the card:

    python portbench/humanoid_faults.py --workload humanoid-v5.collect [calibrate.py's options]

which runs ``calibrate.py`` with this :func:`plant` in ``faults.plant``'s place.
"""

from __future__ import annotations

import contextlib
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]

import torch  # noqa: E402

from portbench import calibrate, faults  # noqa: E402

_PLANT = faults.plant


def plant(fault: str, loop: str, ctrl_cost_weight: float = 0.0):
    """:func:`portbench.faults.plant`, and for ``altered`` Humanoid's reward altered as well."""
    planted = _PLANT(fault, loop, ctrl_cost_weight)
    if fault != "altered":
        return planted
    from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidFunctional

    def altered(old):
        def reward(self, state, action, next_state, rng, params=None):
            return old(self, state, action, next_state, rng, params) + 2 * ctrl_cost_weight * torch.sum(
                torch.square(action), dim=-1)
        return reward

    stack = contextlib.ExitStack()
    stack.enter_context(planted)
    stack.enter_context(faults._patched(HumanoidFunctional, "reward", altered))
    return stack


if __name__ == "__main__":
    faults.plant = plant
    calibrate.main()
