"""Readings that the limits of ``portbench/limits/<cell>.json`` are set from.

    python portbench/calibrate.py --workload <cell> --seeds 12 --first-seed <n> [--seconds 2]
        [--faults unchanged,half,altered] [--fault-seeds 3] [--control-seeds 3] [--out <file>]

from the root of a checkout, on the card. In one process, for the cell at
its own size and load: the program's readings on ``--seeds`` seeds (each a
set-up, a short window of ``--seconds`` and the check, as a run makes
them); the control's on the first ``--control-seeds`` of them (the
reference one precision lower put in the program's place, on the same
inputs: bfloat16 physics, and float8 policy operands for ``ppo`` traffic);
and each planted fault's (``portbench/faults.py``) on
``--fault-seeds`` further seeds. Prints one JSON line a reading and
appends them to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != BENCH]


def cell_for(workload: str, seed: int, seconds: float, device):
    from portbench import drive, run

    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    _, config, traffic, _ = run.resolve(manifest, workload)
    return drive.Cell(workload, config, traffic, seed, seconds, device, time.perf_counter())


def readings_of(kind: str, seed: int, readings: dict, out) -> None:
    line = json.dumps({"kind": kind, "seed": seed, **readings}, default=str)
    print(line, flush=True)
    if out is not None:
        with open(out, "a") as f:
            f.write(line + "\n")


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=3_000_000_000)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--faults", default="unchanged,half,altered")
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--out")
    args = parser.parse_args(argv)

    import torch

    from portbench import drive, faults

    device = torch.device("cuda", 0)
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    for i, seed in enumerate(seeds):
        cell = cell_for(args.workload, seed, args.seconds, device)
        result = drive.run(cell, traced=False)
        readings_of("program", seed, result["readings"], args.out)
        if i < args.control_seeds:
            started = time.perf_counter()
            control = cell.loop().readings(cell, result["kept"], control=True)
            control["_reference_s"] = time.perf_counter() - started
            readings_of("control", seed, control, args.out)
        del result
    fault_seeds = [seeds[-1] + 7919 * (i + 1) for i in range(args.fault_seeds)]
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in fault_seeds:
            cell = cell_for(args.workload, seed, args.seconds, device)
            weight = cell.config["task"].get("ctrl_cost_weight", 0.0)
            with faults.plant(fault, cell.traffic["loop"], weight):
                result = drive.run(cell, traced=False)
            readings_of(f"fault:{fault}", seed, result["readings"], args.out)
            del result


if __name__ == "__main__":
    main()
