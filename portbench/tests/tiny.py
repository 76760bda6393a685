"""Tiny cells for the benchmark's CPU tests: real configurations and
traffic cut to a few envs and steps, written next to the real files under
``_test-`` names and removed again."""

from __future__ import annotations

import contextlib
import copy
import json
import os
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())


def shrink(config: dict, traffic: dict, envs: int = 16) -> tuple[dict, dict]:
    config, traffic = copy.deepcopy(config), copy.deepcopy(traffic)
    config["num_envs"] = envs
    if traffic["loop"] == "rollout":
        config["max_episode_steps"] = 25
        traffic.update(block_steps=10, warmup_blocks=1, trace_blocks=1)
    else:
        # the time limit inside the fourth train step, after the three checked ones
        config["max_episode_steps"] = 30
        traffic["ppo"].update(rollout_steps=8, hidden_sizes=[16, 16])
    return config, traffic


@contextlib.contextmanager
def files(entries: dict):
    """Write ``{relative path under portbench/: JSON object or text}`` and
    remove them afterwards."""
    written = []
    try:
        for rel, body in entries.items():
            path = BENCH / rel
            path.write_text(body if isinstance(body, str) else json.dumps(body))
            written.append(path)
        yield
    finally:
        for path in written:
            path.unlink(missing_ok=True)


@contextlib.contextmanager
def tiny_cell(workload: str, limits_of: str | None = None):
    """A manifest whose cell ``workload`` runs the real cell's
    configuration and traffic cut to a few envs and steps, under the limits
    of the real cell ``limits_of`` (default: the same name). Yields the
    manifest."""
    entry = {w["name"]: w for w in MANIFEST["workloads"]}[limits_of or workload]
    config = json.loads((BENCH / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((BENCH / "traffic" / f"{entry['traffic']}.json").read_text())
    config, traffic = shrink(config, traffic)
    tag = f"_test-{workload}-{os.getpid()}"  # test processes that run side by side write apart
    manifest = copy.deepcopy(MANIFEST)
    manifest["workloads"] = [dict(entry, name=workload, config=tag, traffic=tag)]
    for metric in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in metric and entry["name"] in metric["workloads"]:
            metric["workloads"] = metric["workloads"] + [workload]
    limits = json.loads((BENCH / "limits" / f"{entry['name']}.json").read_text())
    body = {f"configs/{tag}.json": config, f"traffic/{tag}.json": traffic}
    if workload != entry["name"]:
        body[f"limits/{workload}.json"] = limits
    with files(body):
        yield manifest
