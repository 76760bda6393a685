"""The frozen operation and byte counts are what the counting function
gives for today's generator (the program is imported by the tool, not by
the run path)."""

from __future__ import annotations

import json

import pytest

from portbench.counts import freeze
from portbench.tests import tiny

PUBLISHED = {"articulated_half_cheetah_fs5": 15063, "articulated_ant_fs5": 68739}


@pytest.mark.parametrize("build", sorted(freeze.BUILDS))
def test_frozen_counts_are_the_counting_functions(build):
    frozen = json.loads((tiny.BENCH / "counts" / f"{build}.json").read_text())
    counted = freeze.count(*freeze.BUILDS[build])
    assert frozen["operations_per_env"] == counted["operations_per_env"] == PUBLISHED[build]
    assert frozen["bytes_per_env"] == counted["bytes_per_env"]
    assert frozen["taken"]["commit"] and frozen["taken"]["date"]
