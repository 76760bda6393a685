"""The reference against the port at a tiny size on the CPU. This test
imports the program to compare with it; the reference itself does not."""

from __future__ import annotations

import pytest
import torch

from portbench import run
from portbench.reference.physics import Robot
from portbench.tests import tiny

CPU = torch.device("cpu")


def _port(name):
    from gymnasium_tpu_torch.envs.mujoco.ant import AntFunctional
    from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional

    return {"half_cheetah": HalfCheetahFunctional, "ant": AntFunctional}[name]()


@pytest.mark.parametrize("model", ["half_cheetah", "ant"])
def test_reference_step_reset_and_wrenches_match_the_port(model):
    from gymnasium_tpu_torch.ops.articulated_step import make_fused_step

    env, robot = _port(model), Robot(model, 5)
    gen = torch.Generator().manual_seed(5)
    n = 24
    u, z = torch.rand((n, robot.nq), generator=gen), torch.randn((n, robot.nv), generator=gen)
    state = env.reset_values(u, z)
    q_ref, qd_ref = robot.reset(u, z, 0.1)
    assert torch.equal(state["qpos"], q_ref) and torch.equal(state["qvel"], qd_ref)
    step = make_fused_step(env.model, 5, model)
    q, qd = state["qpos"], state["qvel"]
    for _ in range(10):  # into contact
        q, qd = step(q, qd, torch.rand((n, robot.nu), generator=gen) * 2 - 1)
    a = torch.rand((n, robot.nu), generator=gen) * 2.4 - 1.2
    q1, qd1 = step(q, qd, a)
    r1, rd1 = robot.step(q.double(), qd.double(), a.double())
    assert torch.allclose(q1.double(), r1, rtol=1e-5, atol=1e-5)
    assert torch.allclose(qd1.double(), rd1, rtol=1e-4, atol=1e-4)
    w_port = env._dyn["contact_wrenches"](q1, qd1).double()
    w_ref = robot.contact_wrenches(q1.double(), qd1.double())
    assert torch.allclose(w_port, w_ref, rtol=1e-4, atol=1e-3 * float(w_ref.abs().max()) + 1e-6)


@pytest.mark.parametrize("workload", ["halfcheetah-v5.collect", "ant-v5.collect"])
def test_a_tiny_collect_run_is_correct(workload):
    with tiny.tiny_cell(workload) as manifest:
        line, lines = run.run_cell(manifest, workload, 4_000_000_007, 0.2, False, CPU)
    assert line["correct"], lines


def test_a_tiny_train_run_is_correct():
    """The trainer's checked steps and the step that crosses the time limit
    (every lane truncates, then resets) against the reference trainer."""
    with tiny.tiny_cell("halfcheetah-v5.train") as manifest:
        line, lines = run.run_cell(manifest, "halfcheetah-v5.train", 4_000_000_007, 0.2, False, CPU)
    assert line["correct"], lines
    checks = line["checks"]
    assert {"loss_scaled_gap_x", "loss_scaled_gap_1", "grad1_gap_x", "update_gap_x", "state_gap_p99"} <= set(checks)
