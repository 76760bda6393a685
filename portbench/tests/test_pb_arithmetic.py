"""The per-layer and end-to-end arithmetic on windows built by hand."""

from __future__ import annotations

import json
import statistics
import time

import pytest
import torch

from portbench import drive, trace
from portbench.loops import ppo
from portbench.tests import tiny

PEAKS = json.loads((tiny.BENCH / "peaks.json").read_text())
KERNEL = "void art::parts_kernel<ArticulatedStep>(float const*, float const*, float const*, float*, float*, int)"


def window(device_ops, host=(), context=None, span=(0.0, 1000.0)):
    base = {"steps": 10, "units": 1, "num_envs": 16384, "peaks": PEAKS, "counts": None}
    return trace.Trace(list(device_ops), list(host), span[0], span[1], span[1] - 10.0, (span[1] - span[0]) / 1e6,
                       dict(base, **(context or {})))


@pytest.mark.parametrize("build", ["articulated_half_cheetah_fs5", "articulated_ant_fs5"])
def test_the_roofline_share_comes_from_the_frozen_counts(build):
    counts = json.loads((tiny.BENCH / "counts" / f"{build}.json").read_text())
    read = trace.readers(tiny.BENCH / "metrics")["articulated_roofline_pct.collect"]
    ops = [(KERNEL, 100.0 * i, 100.0 * i + 80.0) for i in range(10)] + [("other_kernel", 0.0, 50.0)]
    share = read(window(ops, context={"counts": counts}))
    calls = 10 * 16384
    least = max(counts["operations_per_env"] * calls / 67e12, counts["bytes_per_env"] * calls / 3.35e12)
    assert share == pytest.approx(100 * least / 800e-6)
    # the least time the card could take bounds the share at 100 %
    fastest = [(KERNEL, 0.0, least / 10 * 1e6)] * 10
    assert read(window(fastest, context={"counts": counts})) == pytest.approx(100.0)
    assert read(window([("other_kernel", 0.0, 1.0)], context={"counts": counts})) is None


def test_busy_idle_kernels_and_syncs_of_a_window():
    ops = [("k1", 0.0, 100.0), ("k2", 50.0, 150.0), ("Memcpy HtoD (Pageable -> Device)", 400.0, 500.0)]
    host = [("cudaStreamSynchronize", 10.0, 20.0, 1), ("cudaLaunchKernel", 30.0, 31.0, 1),
            ("cudaDeviceSynchronize", 995.0, 1000.0, 1)]
    w = window(ops, host)
    assert w.busy_s() == pytest.approx(250e-6)
    read = trace.readers(tiny.BENCH / "metrics")
    assert read["device_idle_pct.collect"](w) == pytest.approx(75.0)
    assert read["kernels_per_env_step.collect"](w) == pytest.approx(0.2)
    assert read["host_syncs_per_env_step.collect"](w) == pytest.approx(0.1)  # the closing one not counted
    assert w.idle_gaps() == [(150.0, 400.0), (500.0, 1000.0)]


def test_rate_and_p90_over_a_window_that_holds_a_stall():
    """Every step counts, the stall too: the rate is all the steps' work
    over the whole window, and the stall lies in the tail."""
    config = {"num_envs": 1000, "obs_dim": 17, "action_dim": 6, "max_episode_steps": 10**9}
    traffic = {"loop": "ppo", "ppo": {"rollout_steps": 10, "hidden_sizes": [4], "update_epochs": 1}}
    cell = drive.Cell("t", config, traffic, 1, 0.5, torch.device("cpu"), time.perf_counter())
    pauses = iter([0.2] + [0.01] * 1000)

    def step(state):
        time.sleep(next(pauses))
        return state + 1, {"loss": torch.tensor(0.0)}

    h = ppo.Handle(0, step, None, None, None, {})
    out = ppo.window(cell, h)
    n = out["units"]
    assert h.state == n and n >= 10
    assert out["metrics"]["train_env_steps_per_s"] == pytest.approx(n * 10 * 1000 / out["window_s"])
    times = [0.2] + [0.01] * (n - 1)
    p90 = 1e3 * statistics.quantiles(times, n=10, method="inclusive")[-1]
    assert out["metrics"]["train_step_ms_p90"] == pytest.approx(p90, rel=0.5)
    assert out["window_s"] >= 0.5 and out["window_s"] == pytest.approx(sum(times), rel=0.2)
