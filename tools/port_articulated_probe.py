#!/usr/bin/env python3
"""Sweep the articulated kernel's layouts on one CUDA card.

Run from the repository root on a machine with a card::

    python3 tools/port_articulated_probe.py [--humanoids humanoid humanoidstandup]
        [--models half_cheetah ant] [--robots hopper walker2d_v5 ...]
        [--layouts 8,1 ...] [--block-layouts 4,2 ...] [--no-scaling] [--json PATH]

A layout is ``G,B``: ``G`` warps (partitions) a group of 32 envs and ``B``
groups a block; ``1,4`` is one thread an env, 128 threads a block. Each
variant is a copy of the robot's step carrying the generator's text for its
layout under its own build name (:func:`layout`).

It builds every variant at once and prints, for each, the registers, spills
and stack frame (``-Xptxas -v``), the SASS instructions and code bytes of the
library (``cuobjdump``), the partition (phases, values exchanged, shared
bytes a block) and the layout model's clocks
(``warp_partition.layout_clocks``). It holds every variant bit for bit
against the plain twin at N=4096, at a ragged N and at N=1, then times the
variants of each model by device time (``chip_smoke.device_ms``,
``torch.profiler``) in turns: each once in order, then once in reverse.

- The Humanoid builds (``--humanoids``) take :data:`HUMANOID_LAYOUTS` (or
  ``--layouts``) beside the layout the generator picks.
- HalfCheetah and Ant (``--models``) and the other robots (``--robots``)
  take :data:`BLOCK_LAYOUTS` (or ``--block-layouts``) beside the
  generator's pick.

Where the time goes (``--no-scaling`` skips it): Humanoid's 4-warp layout and
the generator's pick, each at ``frame_skip`` 5 and 1, are timed on 1 to 128
blocks (one block an SM). A kernel bound by its own warps' latency takes
as long on one SM as on 128; one that waits on what the SMs share (L2:
instruction fetch, spills) slows as more SMs run it. The same layout's time
a substep at ``frame_skip`` 1 and 5 tells whether each substep pays the same
again (code fetched again each substep) or the later substeps run faster.
It prints the card's name and power limit and, last, one JSON object of
every number (also written to ``--json``).
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 4096
RAGGED = 333
FRAME_SKIP = 5
ITERS = 20
SCALING_SETS = (1, 8, 16, 32, 64, 128)
#: The layouts tried on both Humanoid builds: 4, 8 and 16 warps a group
#: with the groups a block that fit its shared memory.
HUMANOID_LAYOUTS = ("4,1", "8,1", "16,1")
#: One thread an env, 4, 8 and 16 warps with 1 to 4 groups: the layouts
#: every other robot takes (those that fit), beside the generator's pick.
BLOCK_LAYOUTS = ("1,4", "4,1", "4,2", "4,3", "4,4", "8,1", "8,2", "8,4", "16,1", "16,2")
ROBOTS = ("hopper", "walker2d_v5", "walker2d", "inverted_pendulum", "inverted_double_pendulum", "reacher",
          "pusher_v5", "pusher", "swimmer")
FRAME_SKIPS = {"hopper": 4, "walker2d_v5": 4, "walker2d": 4, "inverted_pendulum": 2,
               "inverted_double_pendulum": 5, "reacher": 2, "pusher_v5": 5, "pusher": 5, "swimmer": 1}


def bits(x):
    return x.contiguous().view(torch.int32)


def parse(spec: str) -> tuple:
    """``G,B`` -> ``(G, B)``."""
    g, b = spec.split(",")
    return int(g), int(b)


def label(spec: tuple) -> str:
    return "g{}x{}".format(*spec)


def variant(step, suffix: str, source):
    """A copy of ``step`` that launches ``source`` under its own build name."""
    other = copy.copy(step)
    other.name = f"{step.name}_{suffix}"
    other._source = source
    other._launch = None
    return other


def layout(step, parts: int, groups: int):
    """A copy of ``step`` in another layout: ``parts`` warps a group of 32
    envs, ``groups`` groups a block (``parts=1``: one thread an env)."""
    from gymnasium_tpu_torch.ops.articulated_codegen import generate_source

    source = generate_source(step.model, step.frame_skip, step.name, parts, groups)
    return variant(step, label((parts, groups)), source)


def _generate(job):
    """``(model name, frame_skip, spec)`` -> the generated source (a worker)."""
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops.articulated_codegen import generate_source

    name, fs, spec = job
    model = load_model(name)[0]
    if spec is None:
        return generate_source(model, fs, name)
    try:
        return generate_source(model, fs, name, *spec)
    except ValueError as err:  # the block does not fit the card
        return str(err)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--humanoids", nargs="*", default=["humanoid", "humanoidstandup"])
    parser.add_argument("--layouts", nargs="+", default=list(HUMANOID_LAYOUTS))
    parser.add_argument("--models", nargs="*", default=["half_cheetah", "ant"])
    parser.add_argument("--robots", nargs="*", default=list(ROBOTS))
    parser.add_argument("--block-layouts", nargs="+", default=list(BLOCK_LAYOUTS),
                        help="the layouts of HalfCheetah, Ant and the other robots")
    parser.add_argument("--no-scaling", action="store_true", help="skip the SM-scaling and frame-skip readings")
    parser.add_argument("--json", help="also write the JSON object to this file")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_articulated_probe: no CUDA device is available", file=sys.stderr)
        return 2

    from chip_smoke import (
        SASS_BYTES,
        articulated_states,
        card_line,
        check,
        cuda_ms,
        device_ms,
        ptxas_summary,
        sass_instructions,
    )
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops import build
    from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

    dev = torch.device("cuda")
    print(card_line(), flush=True)
    start = time.perf_counter()
    plan = {}  # model -> (frame_skip, [spec or None (the generator's pick)])
    for m in args.humanoids:
        plan[m] = (FRAME_SKIP, [None] + [parse(s) for s in args.layouts])
    for m in args.models:
        plan[m] = (FRAME_SKIP, [None] + [parse(s) for s in args.block_layouts])
    for m in args.robots:
        plan[m] = (FRAME_SKIPS[m], [None] + [parse(s) for s in args.block_layouts])
    scaled = {}  # (model, frame_skip, spec) of the scaling readings
    if not args.no_scaling and "humanoid" in args.humanoids:
        for fs in (FRAME_SKIP, 1):
            scaled[("humanoid", fs, parse("4,1"))] = None
            scaled[("humanoid", fs, None)] = None
    jobs = sorted({(m, fs, spec) for m, (fs, specs) in plan.items() for spec in specs} | set(scaled),
                  key=lambda j: (j[0], j[1], str(j[2])))
    with ProcessPoolExecutor(max_workers=8) as pool:
        sources = dict(zip(jobs, pool.map(_generate, jobs)))
    for job, src in list(sources.items()):
        if isinstance(src, str):
            print(f"skipped {job[0]} {label(job[2])}: {src}", flush=True)
            del sources[job]
            scaled.pop(job, None)
    plan = {m: (fs, [spec for spec in specs if (m, fs, spec) in sources]) for m, (fs, specs) in plan.items()}
    jobs = [job for job in jobs if job in sources]
    steps = {}  # job -> step
    base = {}
    for job in jobs:
        m, fs, spec = job
        if (m, fs) not in base:
            base[(m, fs)] = make_fused_step(load_model(m)[0], fs, m)
        src = sources[job]
        shipped = spec is None
        if shipped:
            base[(m, fs)]._source = src
            steps[job] = base[(m, fs)]
        else:
            steps[job] = variant(base[(m, fs)], label(spec), src)
    picked = {m: sources[(m, plan[m][0], None)].layout for m in plan}
    for m, lay in picked.items():
        print(f"{m}: the generator picks {lay['parts']} warps x {lay['env_groups']} groups; model clocks, "
              f"best first: {list(lay['estimates'].items())[:8]}", flush=True)
    print(f"generated {len(jobs)} sources in {time.perf_counter() - start:.1f} s", flush=True)

    texts = {s.build_name: s.source.text for s in steps.values()}
    start = time.perf_counter()
    built = build.build((), texts)
    print(f"built {len(texts)} libraries in {time.perf_counter() - start:.1f} s", flush=True)

    rows = {}
    for job, s in steps.items():
        info = built.get(s.build_name, {})
        lay = {k: v for k, v in s.source.layout.items() if k != "estimates"}
        sass = sass_instructions(build.library_path(s.build_name, s.source.text))
        row = {"model": job[0], "frame_skip": job[1], "layout": label(job[2]) if job[2] else "picked", **lay,
               "ops_per_env": s.source.ops_per_env, "nvcc_s": info.get("seconds"),
               **ptxas_summary(info.get("log", "")), "sass_instructions": sass, "code_bytes": SASS_BYTES * sass}
        rows[s.build_name] = row
        print(f"{s.build_name}: {row}", flush=True)

    # bits: every variant against the plain twin, in every bit, at N=4096, ragged and 1
    for m, (fs, specs) in plan.items():
        group = [steps[(m, fs, spec)] for spec in specs]
        for n in (N, RAGGED, 1):
            inputs = articulated_states(group[0].model, n, dev, seed=3)
            want = group[0].reference(*inputs)
            for s in group:
                got = s(*inputs)
                torch.cuda.synchronize()
                same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
                check(same, f"{s.build_name} N={n} differs from the twin")
                rows[s.build_name][f"bit_equal_n{n}"] = same
            print(f"{m} N={n}: {len(group)} layouts equal the twin in every bit", flush=True)

    # times, in turns: forward, then back
    for m, (fs, specs) in plan.items():
        group = [steps[(m, fs, spec)] for spec in specs]
        inputs = articulated_states(group[0].model, N, dev)
        small = articulated_states(group[0].model, 1, dev, seed=1)
        ragged = articulated_states(group[0].model, RAGGED, dev, seed=2)
        for turn, order in enumerate((group, group[::-1])):
            for s in order:
                ms = device_ms(lambda: s(*inputs), "kernel<ArticulatedStep>", ITERS)
                rows[s.build_name].setdefault("device_ms", []).append(ms)
                rows[s.build_name].setdefault("events_ms_n1", []).append(cuda_ms(lambda: s(*small), ITERS, 3))
                rows[s.build_name].setdefault("events_ms_n333", []).append(cuda_ms(lambda: s(*ragged), ITERS, 3))
                print(f"turn {turn} {s.build_name}: device {ms:.4f} ms a call", flush=True)
        fastest = min(group, key=lambda s: sum(rows[s.build_name]["device_ms"]))
        print(f"{m}: fastest {fastest.build_name}; the generator's pick {group[0].build_name} "
              f"{sum(rows[group[0].build_name]['device_ms']) / 2:.4f} ms", flush=True)

    # time against the SMs in use: one block an SM, 1 to 128 blocks
    scaling = {}
    for job in scaled:
        s = steps[job]
        lay = s.source.layout
        envs = 32 * lay["env_groups"] if lay["parts"] > 1 else 128
        row = scaling.setdefault(s.build_name, {"frame_skip": job[1], "layout": label(job[2]) if job[2] else "picked"})
        for sets in SCALING_SETS:
            inputs = articulated_states(s.model, sets * envs, dev)
            row[sets] = device_ms(lambda: s(*inputs), "kernel<ArticulatedStep>", ITERS)
        print(f"{s.build_name} device ms by sets of groups: {row}", flush=True)

    out = {"card": card_line(), "kind": torch.cuda.get_device_name(0), "rows": rows, "scaling": scaling,
           "picked": {m: {k: v for k, v in lay.items() if k != "estimates"} for m, lay in picked.items()},
           "estimates": {m: lay["estimates"] for m, lay in picked.items()}}
    if args.json:
        Path(args.json).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
