"""The ``rollout`` loop: one caller repeats ``TorchVectorEnv.rollout(block_steps)``
with the default random actions, every trajectory leaf materialised.

Set-up builds the vector env (``make_vec`` in the ``torch`` mode), resets it
with the seed and runs ``warmup_blocks`` blocks; the window runs blocks
until ``seconds`` have passed and closes on a synchronise. It keeps, for
the check, the window's first block, one drawn from the seed (reservoir
sampling), and the first in which lanes that never terminated reach the
time limit and reset; each as the env generator's state, the carry before
the block and its trajectory.
"""

from __future__ import annotations

import random
import time

from portbench import check
from portbench import trace as tracing
from portbench.drive import Cell, report_times, setup_mark, sync


class Handle:
    def __init__(self, env):
        self.env, self.kept = env, []


def setup(cell: Cell) -> Handle:
    from portbench import program

    setup_mark(cell, "program imported")
    env = program.vector_env(cell.config, cell.seed, cell.device)
    setup_mark(cell, "vector env built and reset")
    env.rollout(cell.traffic["block_steps"])
    sync(cell.device)
    setup_mark(cell, "first block (kernel built or loaded)")
    for _ in range(cell.traffic["warmup_blocks"] - 1):
        env.rollout(cell.traffic["block_steps"])
    sync(cell.device)
    setup_mark(cell, "warm")
    return Handle(env)


def window(cell: Cell, h: Handle) -> dict:
    env, t_len, limit = h.env, cell.traffic["block_steps"], cell.config["max_episode_steps"]
    chooser = random.Random(cell.seed)
    done_steps = cell.traffic["warmup_blocks"] * t_len
    first = drawn = at_limit = None
    blocks, times = 0, []
    start = last = time.perf_counter()
    while True:
        before = (env.carry.rng.get_state(), env.carry)
        _, traj = env.rollout(t_len)
        kept = (*before, traj)
        if blocks == 0:
            first = kept
        elif chooser.random() * blocks < 1.0:
            drawn = kept
        lo, hi = done_steps + 1, done_steps + t_len
        if at_limit is None and (hi // (limit + 1)) * (limit + 1) >= lo:
            at_limit = kept
        blocks += 1
        done_steps += t_len
        now = time.perf_counter()
        times.append(now - last)
        last = now
        if now - start >= cell.seconds:
            break
    sync(cell.device)
    window_s = time.perf_counter() - start
    report_times("block", times)
    h.kept = [first] + [b for b in (drawn, at_limit) if b is not None and b is not first]
    steps = blocks * t_len * cell.config["num_envs"]
    return {"units": blocks, "window_s": window_s, "metrics": {"env_steps_per_s": steps / window_s}}


def trace(cell: Cell, h: Handle) -> dict:
    env, t_len, count = h.env, cell.traffic["block_steps"], cell.traffic["trace_blocks"]

    def unit():
        h.kept = [(env.carry.rng.get_state(), env.carry, env.rollout(t_len)[1])]

    traced = tracing.capture(unit, count, cell.context(count * t_len, count), lambda: sync(cell.device))
    return {"units": count, "trace": traced}


def keep(cell: Cell, h: Handle) -> list:
    kept, h.env = h.kept, None
    return kept


def readings(cell: Cell, kept: list, control=None) -> dict:
    """The ``collect`` numbers; ``control`` is the dtype of the reference
    put in the program's place (``True``: bfloat16)."""
    import torch

    dtype = torch.bfloat16 if control is True else control
    return check.collect_readings(cell.task(), cell.config, kept, cell.traffic["check"]["steps_per_block"],
                                  cell.seed, dtype)
