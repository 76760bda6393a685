"""The check fails a run whose timed path is broken underneath, and the
control: the whole run, but the look for a card, on tiny cells (CPU)."""

from __future__ import annotations

import pytest
import torch

from portbench import check, drive, faults, run
from portbench.tests import tiny

CPU = torch.device("cpu")
CELLS = ["halfcheetah-v5.collect", "ant-v5.collect", "halfcheetah-v5.train"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("workload", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(workload, fault):
    with tiny.tiny_cell(workload) as manifest:
        entry, config, traffic, _ = run.resolve(manifest, workload)
        with faults.plant(fault, traffic["loop"], config["task"]["ctrl_cost_weight"]):
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
