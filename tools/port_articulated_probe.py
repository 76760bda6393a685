#!/usr/bin/env python3
"""Sweep the articulated kernel's warp layout on one CUDA card.

Run from the repository root on a machine with a card::

    python3 tools/port_articulated_probe.py [--models half_cheetah ant] [--parts 1 2 4 8]
        [--groups 1 2 3 4] [--no-humanoid]

For each model, at ``frame_skip`` 5 and N=4096, it builds the step with one
thread an env (G = 1); the same program in the partitioned form with a
single partition, one warp a group of 32 envs and four groups a block
(:func:`one_partition`: its out-of-line ``art::sin_cos`` and its carried
values through shared memory, no second warp); and warp-specialised on G
warps a group for each G > 1 of ``--parts`` and each count of env groups a
block of ``--groups``; every build at once. Each variant is a copy of the
shipped step carrying its own text and build name (:func:`layout`,
:func:`variant`); the package's step has one layout per robot. For each
build it prints the registers, spills and stack frame
(``-Xptxas -v``), the SASS instructions of the library (``cuobjdump``) and
the partition (phases, values exchanged, operations recomputed, shared bytes
a block). It holds every variant bit for bit against the G = 1 kernel at
N=4096 and at a ragged N, and the G = 1 kernel against the plain twin
(``chip_smoke.compare_articulated_with_twin``). Then it times every variant
of a model by device time (``chip_smoke.device_ms``, ``torch.profiler``) in
turns: each variant once in order, then once in reverse. Last it builds
Humanoid at HalfCheetah's G, one group a block (its shipped layout; at Ant's
G its exchange buffer would pass the 227 KB a block may have), and holds it
against its twin, a build check only.

Where the time goes: for the one-thread layout and each model's shipped
layout it times one call with 1 to 128 blocks, one block a busy SM. A
kernel bound by its own warps' latency takes as long on one SM as on 128;
one that waits on what the SMs share slows as more SMs run it. The curve
does not say what is shared: the instruction stream of a substep too long
for an SM's instruction cache, L2 and memory (spills), or the clock of a
busier card. It prints the card's name and power limit and, last, one
JSON object of every number.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

N = 4096
FRAME_SKIP = 5
RAGGED = {"half_cheetah": 1000, "ant": 333, "humanoid": 333}
ITERS = 50
SCALING_BLOCKS = (1, 8, 16, 32, 64, 96, 128)


def bits(x):
    return x.contiguous().view(torch.int32)


def variant(step, suffix: str, source):
    """A copy of ``step`` that launches ``source`` under its own build name."""
    other = copy.copy(step)
    other.name = f"{step.name}_{suffix}"
    other._source = source
    other._launch = None
    return other


def layout(step, parts: int, groups: int):
    """A copy of ``step`` in another warp layout: ``parts`` warps a group of
    32 envs and ``groups`` groups a block (``parts=1``: one thread an env)."""
    from gymnasium_tpu_torch.ops.articulated_codegen import generate_source

    return variant(step, f"g{parts}x{groups}", generate_source(step.model, step.frame_skip, step.name, parts, groups))


def one_partition(step, groups: int = 4):
    """A copy of ``step`` whose text is the partitioned form with a single
    partition: the generator's emission for G > 1, run on one warp."""
    from gymnasium_tpu_torch.ops import articulated_codegen as ac
    from gymnasium_tpu_torch.ops.codegen import GeneratedSource
    from gymnasium_tpu_torch.ops.warp_partition import partition

    t = ac.model_tables(step.model)
    prologue, body, outputs = ac.substep_program(t)
    wp = partition(body, 1, t.nq + t.nv)
    lines = ac._partitioned_lines(t, step.frame_skip, step.name, "", "", prologue, outputs, wp, groups)
    source = step.source
    return variant(step, "one_partition", GeneratedSource(
        step.name, source.substeps, "\n".join(lines), source.prologue_ops, source.substep_ops,
        {"parts": 1, "env_groups": groups, "phases": wp.phases, "exchanged": 0, "exchange_loads": 0,
         "recomputed_ops": 0, "shared_bytes_per_block": wp.shared_bytes(groups)}))


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", nargs="+", default=["half_cheetah", "ant"])
    parser.add_argument("--parts", nargs="+", type=int, default=[1, 2, 4, 8])
    parser.add_argument("--groups", nargs="+", type=int, default=[1, 2, 3, 4])
    parser.add_argument("--no-humanoid", action="store_true", help="skip the Humanoid build check")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_articulated_probe: no CUDA device is available", file=sys.stderr)
        return 2

    from chip_smoke import (
        articulated_states,
        card_line,
        check,
        compare_articulated_with_twin,
        device_ms,
        ptxas_summary,
        sass_instructions,
    )
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops import build
    from gymnasium_tpu_torch.ops.articulated_codegen import WARP_PARTS
    from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

    dev = torch.device("cuda")
    print(card_line(), flush=True)
    variants = {}  # model -> [step], the G = 1 step first
    shipped = {}  # model -> the step in its own layout
    for m in args.models:
        model = load_model(m)[0]
        shipped[m] = make_fused_step(model, FRAME_SKIP, m)
        steps = [layout(shipped[m], 1, 4)]
        steps.append(one_partition(shipped[m]))
        for g in sorted(set(args.parts) - {1}):
            for b in args.groups:
                try:
                    steps.append(layout(shipped[m], g, b))
                except ValueError as err:  # the block does not fit the card
                    print(f"skipped {m} G={g} groups={b}: {err}", flush=True)
        variants[m] = steps
    extra = []
    if not args.no_humanoid:
        humanoid = make_fused_step(load_model("humanoid")[0], FRAME_SKIP, "humanoid")
        extra.append(layout(humanoid, WARP_PARTS["half_cheetah"], 1))
    every = [s for steps in variants.values() for s in steps] + extra
    start = time.perf_counter()
    texts = {s.build_name: s.source.text for s in every + list(shipped.values())}
    print(f"generated {len(texts)} sources in {time.perf_counter() - start:.1f} s", flush=True)
    start = time.perf_counter()
    built = build.build((), texts)
    print(f"built in {time.perf_counter() - start:.1f} s", flush=True)

    rows = {}
    for s in every:
        info = built.get(s.build_name, {})
        row = {"model": s.source.name, **s.source.layout, "ops_per_env": s.source.ops_per_env,
               "nvcc_s": info.get("seconds"), **ptxas_summary(info.get("log", "")),
               "sass_instructions": sass_instructions(build.library_path(s.build_name, s.source.text))}
        rows[s.build_name] = row
        print(f"{s.build_name}: {row}", flush=True)

    # bits: every variant against the G = 1 kernel, which is held against the twin
    for m, steps in variants.items():
        for n in (N, RAGGED[m]):
            inputs = articulated_states(steps[0].model, n, dev, seed=3)
            if n == N:
                errs = compare_articulated_with_twin(steps[0], *inputs)
                print(f"{steps[0].build_name} N={n} vs twin: {errs}", flush=True)
            want = steps[0](*inputs)
            for s in steps[1:]:
                got = s(*inputs)
                torch.cuda.synchronize()
                same = all(torch.equal(bits(a), bits(b)) for a, b in zip(got, want))
                check(same, f"{s.build_name} N={n} differs from the one-thread kernel")
                rows[s.build_name][f"bit_equal_n{n}"] = same
            print(f"{m} N={n}: {len(steps) - 1} variants equal the one-thread kernel in every bit", flush=True)

    # times, in turns: forward, then back
    for m, steps in variants.items():
        inputs = articulated_states(steps[0].model, N, dev)
        for turn, order in enumerate((steps, steps[::-1])):
            for s in order:
                ms = device_ms(lambda: s(*inputs), "kernel<ArticulatedStep>", ITERS)
                rows[s.build_name].setdefault("device_ms", []).append(ms)
                print(f"turn {turn} {s.build_name}: device {ms:.4f} ms a call", flush=True)

    for s in extra:  # a build check; chip_smoke.py holds the shipped step to the small-angle side too
        inputs = articulated_states(s.model, RAGGED[s.source.name], dev, seed=3)
        got, want = s(*inputs), s.reference(*inputs)
        torch.cuda.synchronize()
        errs = [float((a - b).abs().max()) for a, b in zip(got, want)]
        check(all(torch.equal(a, b) for a, b in zip(got, want)), f"{s.build_name} differs from the twin by {errs}")
        rows[s.build_name]["vs_twin"] = errs
        inputs = articulated_states(s.model, N, dev)
        rows[s.build_name]["device_ms"] = [device_ms(lambda: s(*inputs), "kernel<ArticulatedStep>", 5)]
        print(f"{s.build_name} N={RAGGED[s.source.name]} vs twin: {errs}; N={N} device "
              f"{rows[s.build_name]['device_ms'][0]:.4f} ms", flush=True)

    # time against the SMs in use: one block a busy SM, up to the card's 132
    scaling = {}
    for m, steps in variants.items():
        for s in (steps[0], shipped[m]):
            shape = s.source.layout
            envs = 32 * shape["env_groups"] if shape["parts"] > 1 else 128
            row = scaling.setdefault(s.build_name, {"parts": shape["parts"], "env_groups": shape["env_groups"]})
            for blocks in SCALING_BLOCKS:
                inputs = articulated_states(s.model, blocks * envs, dev)
                row[blocks] = device_ms(lambda: s(*inputs), "kernel<ArticulatedStep>", ITERS)
            print(f"{s.build_name} device ms by blocks: {row}", flush=True)

    print(json.dumps({"card": card_line(), "kind": torch.cuda.get_device_name(0), "rows": rows,
                      "scaling": scaling}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
