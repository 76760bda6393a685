"""The port's Humanoid-v5 functional env against the benchmark's plain
float64 reference (``portbench/reference/humanoid.py``), which shares no
code with the port, and the spans of its centre-of-mass kinematics (CPU,
small batches)."""

from __future__ import annotations

import collections
import json
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gymnasium_tpu_torch.envs.mujoco.humanoid import HumanoidFunctional
from gymnasium_tpu_torch.vector import TorchVectorEnv
from portbench.reference.humanoid import Humanoid

CONFIG = json.loads((Path(__file__).resolve().parents[1] / "portbench" / "configs" / "humanoid-v5.json").read_text())
N, T = 16, 3
# the observation's blocks, in order: name, width
BLOCKS = [("qpos[2:]", 22), ("qvel", 23), ("cinert", 130), ("cvel", 78), ("qfrc_actuator", 17), ("cfrc_ext", 78)]


@pytest.fixture(scope="module")
def pair():
    return HumanoidFunctional(), Humanoid(CONFIG)


@pytest.fixture(scope="module")
def in_contact(pair):
    """``(q, qd, action, q1, qd1)``: seeded resets, 10 random steps of the
    port's fused step into contact, then one step under ``action``."""
    env, ref = pair
    gen = torch.Generator().manual_seed(11)
    draws = ref.reset_draws(gen, N, "cpu")
    state = env.reset_values(*draws)
    q, qd = state["qpos"], state["qvel"]
    for _ in range(10):
        q, qd = env._step(q, qd, ref.random_actions(gen, N, "cpu"))
    action = ref.random_actions(gen, N, "cpu")
    q1, qd1 = env._step(q, qd, action)
    return q, qd, action, q1, qd1


def test_reset_values_equal_the_reference_reset(pair):
    env, ref = pair
    gen = torch.Generator().manual_seed(3)
    draws = ref.reset_draws(gen, N, "cpu")
    state = env.reset_values(*draws)
    q, qd = ref.reset(draws, torch.float32)
    assert torch.equal(state["qpos"], q) and torch.equal(state["qvel"], qd)


def test_the_fused_step_into_contact_matches_the_reference(pair, in_contact):
    env, ref = pair
    q, qd, action, q1, qd1 = in_contact
    r1, rd1 = ref.step(q.double(), qd.double(), action.double())
    # Ant's tolerances (portbench/tests/test_pb_reference.py): float32 against float64 over 5 substeps
    assert torch.allclose(q1.double(), r1, rtol=1e-5, atol=1e-5)
    assert torch.allclose(qd1.double(), rd1, rtol=1e-4, atol=1e-4)
    # most lanes in contact: some sphere's wrench is not nought
    assert int((ref.robot.contact_wrenches(r1, rd1).abs().amax((1, 2)) > 0).sum()) >= N // 2


def test_every_observation_value_matches_the_reference_block_by_block(pair, in_contact):
    env, ref = pair
    *_, q1, qd1 = in_contact
    port = env.observation({"qpos": q1, "qvel": qd1, "prev_x": q1[:, 0]}, None)
    want = ref.observation(q1.double(), qd1.double())
    assert port.shape == want.shape == (N, 348)
    start = 0
    for name, width in BLOCKS:
        p, r = port[:, start:start + width].double(), want[:, start:start + width]
        start += width
        if name in ("qpos[2:]", "qvel", "qfrc_actuator"):
            # copies of the state the reference was given, and zeros
            assert torch.equal(p, r), name
        elif name == "cinert":
            # float32 constants of the same float64 model values
            assert torch.equal(p, r.float().double()), name
        elif name == "cvel":
            # a float32 forward derivative against float64 Jacobians: float32 rounding over the body chain
            assert torch.allclose(p, r, rtol=1e-4, atol=1e-5 * float(r.abs().max())), name
        else:
            # the contact-wrench kernel's float32 sums of stiff forces: Ant's wrench tolerance
            assert torch.allclose(p, r, rtol=1e-4, atol=1e-3 * float(r.abs().max()) + 1e-6), name
    assert start == 348


def test_reward_matches_the_reference_with_the_healthy_bound_and_the_cost_clamp(pair, in_contact):
    env, ref = pair
    q, qd, action, q1, qd1 = in_contact
    # heights on both sides of each bound of the open range 1 < z < 2, on each bound, and lanes sunk into
    # the ground, whose contact cost the clamp at 10 cuts
    z = torch.tensor([0.4, 0.6, 0.999, 1.0, 1.001, 1.3, 1.999, 2.0, 2.001, 2.3], dtype=torch.float32)
    q1 = q1.clone()
    q1[: len(z), 2] = z
    port = env.reward({"qpos": q}, action, {"qpos": q1, "qvel": qd1}, None)
    want = ref.reward(q.double(), q1.double(), qd1.double(), action.double())
    cost = torch.clamp(5e-7 * torch.sum(ref.robot.contact_wrenches(q1.double(), qd1.double()) ** 2, (1, 2)), max=10.0)
    assert (cost[:2] == 10.0).all() and (cost < 10.0).any()
    healthy = (q1[:, 2] > 1.0) & (q1[:, 2] < 2.0)
    assert healthy.tolist()[:10] == [False, False, False, False, True, True, True, False, False, False]
    # float32 against float64: the forward term's centre-of-mass difference over dt = 0.015 s and the
    # contact cost's sum of squared wrenches, each within 1e-4 of the reward's scale (5 to 10)
    assert torch.allclose(port.double(), want, rtol=1e-5, atol=1e-3)


def test_terminal_matches_the_reference(pair, in_contact):
    env, ref = pair
    *_, q1, qd1 = in_contact
    q1 = q1.clone()
    q1[:6, 2] = torch.tensor([0.5, 1.0, 1.0001, 1.9999, 2.0, 2.5])
    port = env.terminal({"qpos": q1, "qvel": qd1}, None)
    assert torch.equal(port, ref.terminated(q1.double(), qd1.double()))
    assert port[:6].tolist() == [True, True, False, False, True, True]


def test_the_com_kinematics_spans_count_and_change_no_value():
    def rollout(traced: bool):
        func = HumanoidFunctional()
        # a light stand-in for the fused step: under the profiler its CPU twin's ~240,000 operations a step
        # take ~20 s, and the spans counted here are those of the observation and the reward
        func._step = lambda q, qd, action: (q + 0.015 * torch.cat([qd[:, :3], qd[:, 2:]], 1), qd * 0.99)
        env = TorchVectorEnv(func, 4, max_episode_steps=1000, device="cpu")
        env.reset(seed=7)
        if not traced:
            return env.rollout(T)[1], None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traj = env.rollout(T)[1]
        cpu = torch.autograd.DeviceType.CPU
        return traj, collections.Counter(e.name for e in prof.events() if e.device_type == cpu)

    plain, _ = rollout(False)
    traced, found = rollout(True)
    assert found["vector.step"] == T
    assert found["mujoco.com_velocity"] == T  # once an env step, in the observation
    assert found["mujoco.mass_center"] == 2 * T  # twice, in the reward
    assert found["mujoco.contact_wrenches"] == 2 * T  # once in the observation, once in the reward
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)
