#!/usr/bin/env python3
"""Count the torch operations an env step of the port issues, on the CPU.

Runs ``TorchVectorEnv.rollout`` of a functional env of the port on the CPU
under a ``TorchDispatchMode`` and prints, per env, one JSON line: the aten
operations a step (views, which launch nothing on a card, left out), and the
launches a step of the port's own kernels. On the CPU those kernels run as
their plain twins, thousands of operations each; here each call counts as one
launch and its twin's operations are not counted, as on the card::

    python3 tools/port_count_ops.py bipedal_walker bipedal_walker_hardcore lunar_lander

``--envs`` and ``--steps`` set the batch (default 64) and the counted steps
(default 10, after 2 uncounted ones). The counts predict the kernels a step
on the card; they take no time on any device.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import sys
from pathlib import Path

from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from gymnasium_tpu_torch.envs.box2d import bipedal_walker  # noqa: E402
from gymnasium_tpu_torch.ops import planar_step  # noqa: E402
from gymnasium_tpu_torch.vector import TorchVectorEnv  # noqa: E402


def env_factory(name: str):
    """``(functional env, step limit)`` of an env name."""
    if name.startswith("bipedal_walker"):
        from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional

        func = BipedalWalkerFunctional({"hardcore": name.endswith("hardcore")})
        return func, func.max_episode_steps
    if name == "lunar_lander":
        from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional

        return LunarLanderFunctional(), 1000
    raise ValueError(f"unknown env {name!r}")


class Counter(TorchDispatchMode):
    """Counts aten operations by name while ``active``; views are left out."""

    def __init__(self):
        super().__init__()
        self.ops: collections.Counter[str] = collections.Counter()
        self.active = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self.active and not func.is_view:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def kernels_counted_once(counter: Counter, launches: collections.Counter):
    """Within it, each fused planar step and terrain call counts as one
    launch of its kernel, and its twin's operations go uncounted."""
    step_call, terrain_call = planar_step.FusedPlanarStep.__call__, bipedal_walker.walker_terrain

    def quiet(name, fn):
        def call(*args, **kwargs):
            launches[name(*args)] += 1
            counter.active = False
            try:
                return fn(*args, **kwargs)
            finally:
                counter.active = True

        return call

    planar_step.FusedPlanarStep.__call__ = quiet(lambda self, *a: self.build_name, step_call)
    bipedal_walker.walker_terrain = quiet(lambda *a: "walker_terrain", terrain_call)
    try:
        yield
    finally:
        planar_step.FusedPlanarStep.__call__ = step_call
        bipedal_walker.walker_terrain = terrain_call


def count(name: str, envs: int, steps: int) -> dict:
    func, limit = env_factory(name)
    counter, launches = Counter(), collections.Counter()
    with kernels_counted_once(counter, launches):
        env = TorchVectorEnv(func, envs, max_episode_steps=limit, device="cpu")
        env.reset(seed=0)
        env.rollout(2)
        launches.clear()
        with counter:
            env.rollout(steps)
    aten = sum(counter.ops.values())
    return {
        "env": name,
        "envs": envs,
        "steps": steps,
        "aten_ops_a_step": aten / steps,
        "kernel_launches_a_step": {k: v / steps for k, v in launches.items()},
        "top_ops_a_step": {k: v / steps for k, v in counter.ops.most_common(8)},
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("envs_to_count", nargs="+", metavar="env")
    parser.add_argument("--envs", type=int, default=64)
    parser.add_argument("--steps", type=int, default=10)
    args = parser.parse_args()
    for name in args.envs_to_count:
        print(json.dumps(count(name, args.envs, args.steps)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
