"""Per-span table of one traced run of a benchmark cell.

    python tools/port_span_table.py --workload <cell> --seed <n> [--seconds <s>]

Runs the cell as ``python3 portbench/run.py ... --trace 1`` does and prints
its result line; then, one JSON object a line, each program span of the
traced window (``gymnasium_tpu_torch.utils.tracing.span``): its ranges, host
µs an env step of the whole batch (with its children, and its own time
without the program spans directly inside it), kernel launches an env step
(``cudaLaunch*``/``cuLaunch*`` runtime calls that start inside it), and the
device idle ms of the window put down to it (the innermost span at a gap's
middle; ``null``: no span there).
"""

from __future__ import annotations

import argparse
import collections
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import run, spans, trace  # noqa: E402  (run fixes the process's settings on import)


def table(t) -> list[dict]:
    steps = t.context["steps"]
    main = [h for h in t.host if h[0].startswith(spans.PROGRAM)]
    if not main:
        return []
    thread = collections.Counter(h[3] for h in main).most_common(1)[0][0]
    main = sorted((h for h in main if h[3] == thread), key=lambda h: (h[1], -h[2]))
    own = collections.Counter()
    stack = []
    for name, start, end, _ in main:
        while stack and stack[-1][2] <= start:
            stack.pop()
        own[name] += end - start
        if stack:
            own[stack[-1][0]] -= end - start
        stack.append((name, start, end))
    idle = spans.idle_by_innermost(t) or {}
    rows = [{"span": name, "ranges": len(spans.ranges(t, name)),
             "host_us_per_step": spans.host_us(t, name) / steps, "self_us_per_step": own[name] / steps,
             "launches_per_step": spans.calls_inside(t, name, spans.launch) / steps,
             "idle_ms": idle.get(name, 0.0) / 1e3} for name in sorted(own)]
    rows.append({"span": None, "idle_ms": idle.get(None, 0.0) / 1e3,
                 "launches_per_step": sum(spans.launch(h[0]) for h in t.host) / steps,
                 "window_ms": (t.end_us - t.start_us) / 1e3, "steps": steps, "units": t.context["units"]})
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", required=True)
    parser.add_argument("--seconds", default="51")
    args = parser.parse_args()
    kept = {}
    breakdown = trace.breakdown

    def keep(t, top=10):
        kept["trace"] = t
        return breakdown(t, top)

    trace.breakdown = keep
    run.main(["--workload", args.workload, "--seed", args.seed, "--seconds", args.seconds, "--trace", "1"])
    for row in table(kept["trace"]):
        print(json.dumps(row))


if __name__ == "__main__":
    main()
