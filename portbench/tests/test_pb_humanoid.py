"""The two cells added with the Humanoid-v5 configuration, ``humanoid-v5.collect``
and ``ant-v5.train``, at a tiny size on the CPU: a run reads correct, the
control one precision lower and each planted fault do not; Humanoid's
frozen kernel counts are the counting function's; its reference imports
nothing of the program or of JAX."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from portbench import check, drive, humanoid_faults, run
from portbench.counts import freeze
from portbench.tests import tiny

CPU = torch.device("cpu")
CELLS = ["humanoid-v5.collect", "ant-v5.train"]


@pytest.mark.parametrize("workload", CELLS)
def test_a_tiny_run_is_correct(workload):
    with tiny.tiny_cell(workload) as manifest:
        line, lines = run.run_cell(manifest, workload, 4_000_000_007, 0.2, False, CPU)
    assert line["correct"], lines


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    with tiny.tiny_cell(workload) as manifest:
        _, config, traffic, _ = run.resolve(manifest, workload)
        with humanoid_faults.plant(fault, traffic["loop"], config["task"]["ctrl_cost_weight"]):
            line, lines = run.run_cell(manifest, workload, 5_000_000_011, 0.2, False, CPU)
    assert not line["correct"], lines


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_one_precision_lower_fails_the_limits(workload):
    with tiny.tiny_cell(workload) as manifest:
        _, config, traffic, limits = run.resolve(manifest, workload)
        cell = drive.Cell(workload, config, traffic, 6_000_000_013, 0.2, CPU, 0.0)
        result = drive.run(cell, False)
    readings = cell.loop().readings(cell, result["kept"], control=True)
    correct, lines = check.judge(readings, limits)
    assert not correct, lines


def test_humanoid_frozen_counts_are_the_counting_functions():
    frozen = json.loads((tiny.BENCH / "counts" / "articulated_humanoid_fs5.json").read_text())
    counted = freeze.count("humanoid", 5)
    assert frozen["operations_per_env"] == counted["operations_per_env"] == 142_881
    assert {k: frozen[k] for k in counted} == counted
    assert frozen["taken"]["commit"] and frozen["taken"]["date"]


def test_the_humanoid_reference_imports_nothing_of_the_program_or_jax():
    code = ("import sys, json; import portbench.reference.humanoid; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT, capture_output=True, text=True, check=True)
    loaded = set(json.loads(out.stdout))
    assert not loaded & {"gymnasium_tpu_torch", "gymnasium_tpu", "jax", "jaxlib", "flax"}, loaded
    assert "portbench" in loaded
