#!/usr/bin/env python3
"""Time the generated articulated kernel over batch size and ``frame_skip``, on one CUDA card.

Run from the repository root on a machine with a card::

    python3 tools/port_articulated_probe.py [--models half_cheetah ant]

For each model it builds the port's fused step for ``frame_skip`` 1 and 5
(every build at once, through ``gymnasium_tpu_torch.ops.build``), counts the
SASS instructions of each library with ``cuobjdump``, and times one call of
the step with CUDA events (``chip_smoke.cuda_ms``) over batches of 1024 to
65536 envs. If the time does not grow with the batch, each SM walks the long
instruction stream at a pace the batch does not set (latency); if it grows
in proportion, the kernel issues at its rate. It prints one line per
measurement, the card's name and power limit, and last one JSON object of
every number.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BATCHES = (1024, 4096, 16384, 65536)
FRAME_SKIPS = (1, 5)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--models", nargs="+", default=["half_cheetah", "ant"])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("port_articulated_probe: no CUDA device is available", file=sys.stderr)
        return 2

    from chip_smoke import articulated_states, card_line, cuda_ms, sass_instructions
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops import build
    from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

    steps = [make_fused_step(load_model(m)[0], fs, m) for m in args.models for fs in FRAME_SKIPS]
    built = build.build((), {s.build_name: s.source.text for s in steps})
    for name, info in built.items():
        print(f"built {name} in {info['seconds']:.2f} s", flush=True)

    dev = torch.device("cuda")
    print(card_line(), flush=True)
    results = []
    for step in steps:
        sass = sass_instructions(build.library_path(step.build_name, step.source.text))
        for n in BATCHES:
            inputs = articulated_states(step.model, n, dev)
            ms = cuda_ms(lambda: step(*inputs), 50, 5)
            row = {"model": step.name, "frame_skip": step.frame_skip, "n": n, "ms": ms,
                   "sass_instructions": sass, "ops_per_env": step.source.ops_per_env,
                   "us_per_substep": ms * 1e3 / step.frame_skip, "env_steps_per_s": n / ms * 1e3}
            results.append(row)
            print(f"{step.build_name} N={n}: {ms:.4f} ms/call, {row['us_per_substep']:.2f} us/substep, "
                  f"{sass} SASS instructions, {row['ops_per_env']} operations an env-call", flush=True)
    print(json.dumps({"card": card_line(), "kind": torch.cuda.get_device_name(0), "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
