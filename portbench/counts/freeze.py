"""Freeze the articulated kernels' operation and byte counts for the cells.

Run from the repository's root on the CPU (it needs no card):

    python portbench/counts/freeze.py

For each build it traces the program's substep generator
(``gymnasium_tpu_torch/ops/articulated_codegen.py::substep_program``) and
counts, with the arithmetic below, the operations one env's call runs:
every distinct operation once, the once-a-call prologue plus ``frame_skip``
passes of the substep. Bytes count each input float read once and each
output float written once. The run path of the benchmark reads only the
JSON files this writes, so a later change to the program cannot move the
yardstick; this script is how the counts were taken, and the CPU tests
check that it still gives them.
"""

from __future__ import annotations

import collections
import datetime
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BUILDS = {"articulated_half_cheetah_fs5": ("half_cheetah", 5), "articulated_ant_fs5": ("ant", 5)}


def count(model_name: str, frame_skip: int) -> dict:
    """Operations and bytes of one env's call of the build."""
    sys.path.insert(0, str(ROOT))
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
    from gymnasium_tpu_torch.ops.articulated_codegen import model_tables, substep_program

    model, _ = load_model(model_name)
    tables = model_tables(model)
    prologue, body, _ = substep_program(tables)
    prologue_ops = collections.Counter(n.kind for n in prologue)
    substep_ops = collections.Counter(n.kind for n in body)
    operations = sum(prologue_ops.values()) + frame_skip * sum(substep_ops.values())
    floats = (tables.nq + tables.nv + tables.nu) + (tables.nq + tables.nv)
    return {"model": model_name, "frame_skip": frame_skip, "operations_per_env": operations,
            "bytes_per_env": 4 * floats, "prologue_ops": dict(sorted(prologue_ops.items())),
            "substep_ops": dict(sorted(substep_ops.items()))}


def main() -> None:
    commit = subprocess.run(["git", "rev-parse", "HEAD"], cwd=ROOT, capture_output=True, text=True).stdout.strip()
    for name, (model_name, frame_skip) in BUILDS.items():
        counts = count(model_name, frame_skip)
        counts["taken"] = {"date": datetime.date.today().isoformat(), "commit": commit}
        (Path(__file__).parent / f"{name}.json").write_text(json.dumps(counts, indent=1) + "\n")
        print(name, counts["operations_per_env"], counts["bytes_per_env"])


if __name__ == "__main__":
    main()
