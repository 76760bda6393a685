#!/usr/bin/env python3
"""Fit the articulated layout model to the probe's measurements (CPU only).

    python3 tools/port_articulated_fit.py probe_b.json [more.json ...]

Each file is the JSON object ``tools/port_articulated_probe.py --json``
writes. For every measured build of one block a layout (its device ms at
N=4096, and its times on 1 to 128 sets of groups when the probe took them;
rows of layouts the generator no longer makes, over a thread-block cluster
or with values stored late, are left out) the script rebuilds the layout's
partition as the generator does and fits the constants of ``warp_partition.MODEL``
(differential evolution over their logarithms, each within a box of
plausible values, :data:`BOUNDS`, then Nelder-Mead) so that
``layout_clocks`` at 1.98 GHz best matches the measured times in the least
squares of their logarithms, each robot weighing the same, and ranks each
robot's builds at N=4096 as the card does wherever one is 3 % faster, its
fastest first; the search starts from ``MODEL``. It prints the fitted
constants, each build's measured and modelled ms, and, for each model, the
fastest build measured against the one the fitted model ranks first. Paste
the constants into ``MODEL`` by hand. The fit is in sample: the same runs
fit the constants and judge the ranking, with no held-out check.
"""

from __future__ import annotations

import collections
import functools
import json
import math
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

CLOCK_HZ = 1.98e9  # the H100's boost clock, as PERF.md's bounds take it
RANK_WEIGHT = 30.0  # weight of a pair of builds that the model ranks against the card
FIRST_WEIGHT = 300.0  # weight of a build that the model puts ahead of the robot's fastest
MARGIN = 0.02  # by how much (in log) the model should put the faster build of a pair ahead
SEARCH_GENERATIONS = 40
#: The box each constant is fitted in: values an H100 could plausibly have.
BOUNDS = {
    "issue_scale": (0.5, 4.0), "latency_scale": (0.8, 3.0), "block_barrier": (10.0, 2000.0),
    "barrier_warp": (0.01, 100.0), "exchange": (0.1, 50.0),
    "spill_live": (100.0, 600.0), "spill_bytes": (32.0, 4096.0), "icache_bytes": (16_384.0, 524_288.0),
    "warm_fetch": (0.01, 1.0), "l2_sms": (8.0, 64.0), "l2_rate": (500.0, 20_000.0),
}
FITTED = ("issue_scale", "latency_scale", "block_barrier", "barrier_warp", "exchange", "spill_live",
          "spill_bytes", "icache_bytes", "warm_fetch", "l2_sms", "l2_rate")


@functools.lru_cache(maxsize=None)
def _partition(model: str, parts: int):
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops.articulated_codegen import model_tables, substep_program
    from gymnasium_tpu_torch.ops.warp_partition import partition

    t = model_tables(load_model(model)[0])
    return partition(substep_program(t)[1], parts, t.nq + t.nv)


def _layout(row: dict) -> tuple | None:
    """``(parts, groups)`` of a probe row, or None for a layout the
    generator no longer makes (a cluster of blocks, late stores)."""
    if row.get("ranks", 1) > 1 or row.get("stores") == "late":
        return None
    return row["parts"], row["env_groups"]


def samples(paths) -> list:
    """``(model, frame_skip, layout, envs, measured ms, label)`` of every measurement."""
    out = []
    for path in paths:
        data = json.loads(Path(path).read_text())
        rows = data["rows"]
        for name, row in rows.items():
            if row.get("device_ms") and _layout(row):
                out.append((row["model"], row["frame_skip"], _layout(row), 4096,
                            sum(row["device_ms"]) / len(row["device_ms"]), f"{Path(path).stem}:{name}"))
        for name, curve in data.get("scaling", {}).items():
            row = rows[name]
            lay = _layout(row)
            if lay is None:
                continue
            per_set = 32 * lay[1] if lay[0] > 1 else 128
            for sets, ms in curve.items():
                if sets.isdigit():
                    out.append((row["model"], row["frame_skip"], lay, int(sets) * per_set, ms,
                                f"{Path(path).stem}:{name}@{sets}"))
    return out


def modelled_ms(sample, constants: dict) -> float:
    from gymnasium_tpu_torch.ops.warp_partition import layout_clocks

    model, fs, (parts, groups), envs, _, _ = sample
    return layout_clocks(_partition(model, parts), groups, envs, fs, constants)["clocks"] / CLOCK_HZ * 1e3


def fit(points) -> dict:
    from scipy.optimize import differential_evolution, minimize

    from gymnasium_tpu_torch.ops.warp_partition import MODEL

    start = np.log([MODEL[k] for k in FITTED])
    weight = collections.Counter(p[0] for p in points)  # each robot weighs the same
    # pairs of one robot's builds at N=4096 where one is clearly (3 %) faster:
    # the model must rank them so too, and each robot's fastest build first
    at_n = [p for p in points if p[3] == 4096 and "@" not in p[5]]
    pairs = [(a, b) for a in at_n for b in at_n if a[0] == b[0] and a[4] < 0.97 * b[4]]
    fastest = {m: min((p for p in at_n if p[0] == m), key=lambda p: p[4]) for m in {p[0] for p in at_n}}
    firsts = [(fastest[p[0]], p) for p in at_n if p is not fastest[p[0]]]

    def loss(x):
        constants = dict(zip(FITTED, np.exp(x)))
        ms = {p[5]: math.log(modelled_ms(p, constants)) for p in points}
        fit_error = sum((ms[p[5]] - math.log(p[4])) ** 2 / weight[p[0]] for p in points)
        misranked = sum(max(0.0, ms[a[5]] - ms[b[5]] + MARGIN) ** 2 for a, b in pairs)
        not_first = sum(max(0.0, ms[a[5]] - ms[b[5]] + MARGIN) ** 2 for a, b in firsts)
        return fit_error + RANK_WEIGHT * misranked + FIRST_WEIGHT * not_first

    # a global search within the card's plausible values, then Nelder-Mead
    # from its best, held to the same box
    bounds = np.log([BOUNDS[k] for k in FITTED])
    start = np.clip(start, bounds[:, 0], bounds[:, 1])
    found = differential_evolution(loss, bounds, seed=0, popsize=10, maxiter=SEARCH_GENERATIONS, tol=1e-6,
                                   polish=False, init="sobol", x0=start)
    best = minimize(lambda x: loss(np.clip(x, bounds[:, 0], bounds[:, 1])), found.x, method="Nelder-Mead",
                    options={"maxiter": 3000, "xatol": 1e-3, "fatol": 1e-6})
    x = np.clip(best.x, bounds[:, 0], bounds[:, 1])
    return dict(zip(FITTED, np.exp(x))), loss(x)


def main() -> int:
    from gymnasium_tpu_torch.ops.warp_partition import MODEL

    points = samples(sys.argv[1:])
    print(f"{len(points)} measurements; loss at MODEL: "
          f"{sum((math.log(modelled_ms(p, MODEL)) - math.log(p[4])) ** 2 for p in points):.4f}", flush=True)
    constants, loss = fit(points)
    print(f"fitted (loss {loss:.4f}): " + json.dumps({k: round(v, 3) for k, v in constants.items()}), flush=True)
    for p in points:
        print(f"{p[5]}: measured {p[4]:.4f} ms, modelled {modelled_ms(p, constants):.4f}")
    for model in sorted({p[0] for p in points}):
        mine = [p for p in points if p[0] == model and p[3] == 4096 and "@" not in p[5]]
        if mine:
            fastest = min(mine, key=lambda p: p[4])
            ranked = min(mine, key=lambda p: modelled_ms(p, constants))
            print(f"{model}: fastest measured {fastest[5]} ({fastest[4]:.4f} ms); the model's first "
                  f"{ranked[5]} ({ranked[4]:.4f} ms measured)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
