"""One short run of each cell on the card: ``python -m pytest -m gpu portbench/tests``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from portbench.tests import tiny


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", [w["name"] for w in tiny.MANIFEST["workloads"]])
def test_a_short_run_of_the_cell_is_correct(card, workload):
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload, "--seed", str(2**31 + 99),
                          "--seconds", "2", "--trace", "0"], cwd=tiny.ROOT, capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", line
