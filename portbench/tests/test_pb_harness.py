"""The harness finds every cell's parts by name, prints exactly the result
line's keys, and loads nothing of JAX or the JAX package (CPU, tiny sizes)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import drive, run, trace
from portbench.tests import tiny

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


def test_every_cell_config_mix_and_metric_is_found_by_name():
    manifest = tiny.MANIFEST
    for cell in manifest["workloads"]:
        entry, config, traffic, limits = run.resolve(manifest, cell["name"])
        assert entry["config"] in {c["name"] for c in manifest["configs"]}
        assert (tiny.BENCH / "loops" / f"{traffic['loop']}.py").exists() and limits
        assert (tiny.BENCH / "counts" / f"{config['kernel_counts']}.json").exists()
        cell = drive.Cell(cell["name"], config, traffic, 1, 1.0, CPU, 0.0)
        assert hasattr(cell.task(), "random_actions") and hasattr(cell.loop(), "readings")
    for config in manifest["configs"]:
        assert (tiny.ROOT / config["file"]).exists()
    readers = trace.readers(tiny.BENCH / "metrics")
    assert {m["name"] for m in manifest["per_layer"]} <= set(readers)


def test_a_config_mix_and_metric_are_added_by_files_and_entries_alone():
    """A dummy configuration, traffic mix, per-layer metric and cell,
    written by this test and removed again, run without any edit."""
    config = json.loads((tiny.BENCH / "configs" / "halfcheetah-v5.json").read_text())
    traffic = json.loads((tiny.BENCH / "traffic" / "collect.json").read_text())
    config, traffic = tiny.shrink(config, traffic, envs=8)
    traffic["block_steps"] = 5
    manifest = json.loads(json.dumps(tiny.MANIFEST))
    manifest["configs"].append({"name": "_test-dummy", "source": "https://example.org",
                                "file": "portbench/configs/_test-dummy.json", "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "_test-dummy.mix", "config": "_test-dummy", "traffic": "_test-mix",
                                  "chips": 1, "why": "test"})
    manifest["end_to_end"][1]["workloads"].append("_test-dummy.mix")
    manifest["per_layer"].append({"name": "_test_blocks.collect", "unit": "blocks", "better": "higher",
                                  "source": "device_trace", "layer": "device (one H100)",
                                  "moves": "env_steps_per_s", "workloads": ["_test-dummy.mix"]})
    reader = "def read(trace):\n    return float(trace.context['units'])\n"
    limits = json.loads((tiny.BENCH / "limits" / "halfcheetah-v5.collect.json").read_text())
    body = {"configs/_test-dummy.json": config, "traffic/_test-mix.json": traffic,
            "metrics/_test_blocks.collect.py": reader, "limits/_test-dummy.mix.json": limits}
    with tiny.files(body):
        plain, _ = run.run_cell(manifest, "_test-dummy.mix", 5, 0.2, False, CPU)
        traced, _ = run.run_cell(manifest, "_test-dummy.mix", 5, 0.2, True, CPU)
    assert set(plain["metrics"]) == {"setup_s", "env_steps_per_s"}
    assert traced["metrics"]["_test_blocks.collect"]["value"] == 1.0
    assert plain["correct"] and traced["correct"]
    assert not any((tiny.BENCH / rel).exists() for rel in body)


LOOP = """from portbench.loops import rollout

setup, trace, keep, readings = rollout.setup, rollout.trace, rollout.keep, rollout.readings


def window(cell, h):
    out = rollout.window(cell, h)
    out["metrics"] = {"env_steps_per_s": 123.0}
    return out
"""

TASK = """from portbench.reference.physics import Locomotion

STEPS = []


class Task(Locomotion):
    def step(self, q, qd, action):
        STEPS.append(q.shape[0])
        return super().step(q, qd, action)
"""


def test_a_loop_and_a_reference_engine_are_added_by_files_alone():
    """A dummy loop and a dummy reference task, found by the names that a
    traffic file and a configuration give, written by this test and
    removed again, run without any edit."""
    import importlib
    import sys as _sys

    config = json.loads((tiny.BENCH / "configs" / "halfcheetah-v5.json").read_text())
    traffic = json.loads((tiny.BENCH / "traffic" / "collect.json").read_text())
    config, traffic = tiny.shrink(config, traffic, envs=8)
    config["reference"] = "_test_engine.Task"
    traffic["loop"] = "_test_loop"
    manifest = json.loads(json.dumps(tiny.MANIFEST))
    manifest["configs"].append({"name": "_test-engine", "source": "https://example.org",
                                "file": "portbench/configs/_test-engine.json", "reduced": [], "why": "test"})
    manifest["workloads"].append({"name": "_test-engine.loop", "config": "_test-engine", "traffic": "_test-loop",
                                  "chips": 1, "why": "test"})
    manifest["end_to_end"][1]["workloads"].append("_test-engine.loop")
    limits = json.loads((tiny.BENCH / "limits" / "halfcheetah-v5.collect.json").read_text())
    body = {"configs/_test-engine.json": config, "traffic/_test-loop.json": traffic,
            "limits/_test-engine.loop.json": limits, "loops/_test_loop.py": LOOP,
            "reference/_test_engine.py": TASK}
    with tiny.files(body):
        importlib.invalidate_caches()
        line, lines = run.run_cell(manifest, "_test-engine.loop", 5, 0.2, False, CPU)
        engine = _sys.modules["portbench.reference._test_engine"]
    for name in ("portbench.loops._test_loop", "portbench.reference._test_engine"):
        _sys.modules.pop(name, None)
    assert line["metrics"]["env_steps_per_s"]["value"] == 123.0
    assert engine.STEPS and set(engine.STEPS) == {8}
    assert line["correct"], lines
    assert not any((tiny.BENCH / rel).exists() for rel in body)


@pytest.mark.parametrize("traced", [False, True])
def test_the_last_line_holds_exactly_the_result_keys(traced):
    with tiny.tiny_cell("halfcheetah-v5.collect") as manifest:
        line, lines = run.run_cell(manifest, "halfcheetah-v5.collect", 2**31 + 12345, 0.2, traced, CPU)
    keys = KEYS[:5] + (["breakdown"] if traced else []) + ["checks"]
    assert list(line) == keys
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if traced else set())
    assert list(line["checks"]) == [x["name"] for x in lines]
    assert all(set(v) == {"value", "limit"} for v in line["checks"].values())
    for metric in line["metrics"].values():
        assert set(metric) == {"value", "unit"}
    if traced:
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert set(line["metrics"]) <= {m["name"] for m in tiny.MANIFEST["per_layer"]}
    else:
        assert set(line["metrics"]) == {"setup_s", "env_steps_per_s"}
    json.dumps(line)


def test_forbidden_modules_are_compared_by_whole_top_level_name(monkeypatch):
    for name in ("gymnasium_tpu_torch", "gymnasium_tpu_torch.ops", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gymnasium_tpu.envs", sys)
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["gymnasium_tpu.envs", "jax.numpy"]


def test_a_run_loads_nothing_of_jax_or_the_jax_package():
    """A whole tiny run, traced, in a fresh process: no module whose
    top-level name is jax, jaxlib, flax or gymnasium_tpu."""
    code = (
        "import sys, torch\n"
        "from portbench import run\n"
        "from portbench.tests import tiny\n"
        "with tiny.tiny_cell('_test-imports', 'ant-v5.collect') as m:\n"
        "    run.run_cell(m, '_test-imports', 7, 0.1, True, torch.device('cpu'))\n"
        "print('FOUND', run.forbidden_modules())\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "FOUND []"


def test_the_command_refuses_to_run_without_a_card():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "halfcheetah-v5.collect", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""


def _imported(path):
    import ast

    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(tiny.BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(tiny.BENCH)))
def test_no_source_imports_jax_and_the_reference_imports_nothing_of_the_program(path):
    names = set(_imported(path))
    assert not names & {"jax", "jaxlib", "flax", "gymnasium_tpu"}, names
    if path.parent.name == "reference":
        assert "gymnasium_tpu_torch" not in names, names
