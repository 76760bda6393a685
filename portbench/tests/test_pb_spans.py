"""The readers of the program's spans, on windows built by hand, and on the
tiny cells' traced runs (CPU)."""

from __future__ import annotations

import json

import pytest
import torch

from portbench import run, trace
from portbench.tests import tiny

READ = trace.readers(tiny.BENCH / "metrics")
SPANS = [m for m in tiny.MANIFEST["per_layer"] if m["source"] == "program_span"]
NEW = [m["name"] for m in SPANS if m["name"] not in ("ppo_rollout_ms.train", "ppo_update_ms.train")]
HOST_US = {"sampler_us_per_env_step.collect": "vector.actions", "transition_us_per_env_step.collect": "func.transition",
           "reset_us_per_env_step.collect": "func.reset", "observation_us_per_env_step.collect": "func.observation",
           "wrenches_us_per_env_step.collect": "mujoco.contact_wrenches"}
TRAIN_MS = {"ppo_policy_ms.train": "ppo.policy", "ppo_env_step_ms.train": "ppo.env_step",
            "ppo_advantages_ms.train": "ppo.advantages", "ppo_backward_ms.train": "ppo.backward"}
MAIN = 7


def window(host=(), device_ops=(("k", 0.0, 1000.0),), steps=10, units=1):
    context = {"steps": steps, "units": units, "num_envs": 16, "peaks": {}, "counts": None}
    return trace.Trace(list(device_ops), list(host), 0.0, 1000.0, 990.0, 1e-3, context)


def span(name, start, end, thread=MAIN):
    return (name, float(start), float(end), thread)


def test_every_new_reader_has_its_entry_and_a_layer_the_manifest_had():
    layers = {m["layer"] for m in tiny.MANIFEST["per_layer"] if m["name"] not in NEW}
    assert len(NEW) == 13 and set(NEW) <= set(READ)
    for m in SPANS:
        assert m["layer"] in layers and m["workloads"], m["name"]


@pytest.mark.parametrize("name", NEW)
def test_a_reader_returns_none_when_its_span_is_absent(name):
    """As on a program without the spans: only the harness's and aten's events."""
    w = window([span("portbench.sync", 990, 1000), span("aten::add", 10, 20), span("cudaLaunchKernel", 11, 12)])
    assert READ[name](w) is None


@pytest.mark.parametrize("name", sorted(HOST_US))
def test_host_us_an_env_step_sums_every_range_children_included(name):
    own = HOST_US[name]
    host = [span("vector.step", 0, 100), span(own, 10, 40), span("aten::mul", 12, 30),
            span("vector.step", 100, 200), span(own, 110, 125), span("other.span", 300, 400)]
    if own != "mujoco.contact_wrenches":
        host.append(span("mujoco.contact_wrenches", 112, 120))  # a child counts inside its parent
    assert READ[name](window(host, steps=10)) == pytest.approx((30 + 15) / 10)


@pytest.mark.parametrize("name", sorted(TRAIN_MS))
def test_host_ms_a_train_step(name):
    own = TRAIN_MS[name]
    host = [span("ppo.rollout", 0, 500), span(own, 10, 1010), span(own, 2000, 4000), span("ppo.update", 500, 900)]
    assert READ[name](window(host, units=2)) == pytest.approx((1000 + 2000) / 2 / 1e3)


def test_syncs_and_launches_count_where_they_start():
    host = [span("vector.actions", 0, 50), span("cudaStreamSynchronize", 5, 30, thread=99),
            span("cudaMemcpy", 40, 60, thread=99), span("cudaStreamSynchronize", 60, 70),
            span("cudaLaunchKernel", 45, 46),
            span("func.reward", 100, 300), span("mujoco.contact_wrenches", 110, 200),
            span("cudaLaunchKernel", 120, 121, thread=99), span("cuLaunchKernelEx", 150, 151),
            span("cudaLaunchKernel", 250, 251),  # in the reward, outside the wrenches
            span("mujoco.contact_wrenches", 400, 410), span("cudaLaunchKernel", 420, 421)]
    w = window(host, steps=4)
    assert READ["sampler_syncs_per_env_step.collect"](w) == pytest.approx(2 / 4)
    assert READ["wrench_kernels_per_env_step.collect"](w) == pytest.approx(2 / 4)
    quiet = window([span("vector.actions", 0, 50), span("mujoco.contact_wrenches", 60, 70)])
    assert READ["sampler_syncs_per_env_step.collect"](quiet) == 0.0
    assert READ["wrench_kernels_per_env_step.collect"](quiet) == 0.0


@pytest.mark.parametrize("kind", ["collect", "train"])
def test_idle_under_a_container_is_unattributed_under_a_leaf_attributed(kind):
    read = READ[f"idle_unattributed_pct.{kind}"]
    outer, inner = ("vector.rollout", "vector.step") if kind == "collect" else ("ppo.rollout", "ppo.env_step")
    leaf = "func.observation"
    host = [span(outer, 0, 900), span(inner, 0, 300), span(leaf, 20, 200), span("mujoco.contact_wrenches", 40, 60),
            span("aten::sum", 45, 55),  # not a program span: the wrench call stays innermost
            span(inner, 300, 600), span(leaf, 310, 320), span(inner, 600, 900)]
    ops = [("k", 0, 40), ("k", 60, 100), ("k", 120, 250), ("k", 260, 400), ("k", 420, 900), ("k", 960, 1000)]
    # gaps: 40-60 under the wrenches, 100-120 under the observation (leaves),
    # 250-260 in the env step's self time, 400-420 in the env step, 900-960 outside every span
    assert read(window(host, ops)) == pytest.approx(100 * (10 + 20 + 60) / (20 + 20 + 10 + 20 + 60))
    everywhere = window(host, [("k", 0, 40), ("k", 60, 1000)])
    assert read(everywhere) == 0.0
    assert read(window(host, [])) is None  # no device, no idle time to put down
    assert read(window([span("aten::sum", 0, 10)], ops)) is None
    # spans of another thread are not the program's main line
    assert read(window(host + [span("ppo.backward", 240, 270, thread=3)], ops)) == pytest.approx(
        100 * 90 / 130)


@pytest.mark.parametrize("cell", [w["name"] for w in tiny.MANIFEST["workloads"]])
def test_a_tiny_traced_run_reports_each_span_metric_of_its_cell(cell):
    wanted = [m["name"] for m in SPANS if cell in m["workloads"]]
    with tiny.tiny_cell(cell) as manifest:
        line, _ = run.run_cell(manifest, cell, 2**31 + 777, 0.1, True, torch.device("cpu"))
    # the CPU runs no device operation, so no idle time is put down
    expected = {m for m in wanted if not m.startswith("idle_unattributed_pct")}
    assert set(line["metrics"]) & set(wanted) == expected
    for name in expected:
        assert line["metrics"][name]["value"] >= 0.0, name
    assert all(line["metrics"][m]["value"] > 0.0 for m in expected if "_us_" in m or "_ms" in m)
    json.dumps(line)
