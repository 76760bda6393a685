"""The port's spans (``gymnasium_tpu_torch.utils.tracing.span``): off the
hot path with no profiler active, each recorded where its layer's work
happens under one, and changing no value either way (CPU, tiny sizes)."""

from __future__ import annotations

import collections
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.utils import tracing
from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward

CPU = torch.device("cpu")
N, T = 8, 3
STEP_SPANS = ("vector.actions", "func.transition", "func.reset", "func.observation", "func.reward")
PPO = ppo.PPOConfig(num_envs=8, rollout_steps=4, hidden_sizes=(16, 16), num_minibatches=2, update_epochs=2,
                    max_episode_steps=50, compute_dtype=torch.float32)


def vector_env(env_id: str, seed: int = 3):
    env = gym.make_vec(env_id, num_envs=N, vectorization_mode="torch",
                       vector_kwargs={"device": CPU, "max_episode_steps": 1000})
    env.reset(seed=seed)
    return env


def train_step(seed: int = 5):
    env = HalfCheetahFunctional()
    wrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    state, params = ppo.init_ppo(env, PPO, seed, wrappers, CPU)
    state, metrics = ppo.make_train_step(env, PPO, params, wrappers)(state)
    return state, metrics


def ranges(prof) -> list:
    """``(name, start_us, end_us, thread)`` of the host's events."""
    cpu = torch.autograd.DeviceType.CPU
    return [(e.name, e.time_range.start, e.time_range.end, e.thread) for e in prof.events() if e.device_type == cpu]


def counts(events) -> collections.Counter:
    return collections.Counter(name for name, *_ in events)


def test_with_no_profiler_a_span_is_the_shared_null_context(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler active")

    assert tracing.span("vector.step") is tracing.span("func.reward")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with tracing.span("vector.step") as inner:
        assert inner is None
    _, traj = vector_env("HalfCheetah-v5").rollout(T)
    assert traj.obs.shape == (T, N, 17)
    _, metrics = train_step()
    assert torch.isfinite(metrics["loss"])


def test_no_port_source_enters_record_function_but_the_span():
    root = Path(gym.__file__).parent
    users = sorted(str(p.relative_to(root)) for p in root.rglob("*.py")
                   if "record_function(" in p.read_text() and "build" not in p.parts)
    assert users == ["utils/tracing.py"]


@pytest.mark.parametrize("env_id, wrenches", [("HalfCheetah-v5", 0), ("Ant-v5", 2)])
def test_a_rollout_records_each_span_inside_its_env_step(env_id, wrenches):
    env = vector_env(env_id)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        env.rollout(T)
    events = ranges(prof)
    found = counts(events)
    assert found["vector.rollout"] == 1
    assert found["vector.step"] == T
    for name in STEP_SPANS:
        assert found[name] == T, name
    assert found["mujoco.contact_wrenches"] == wrenches * T
    (block,) = [e for e in events if e[0] == "vector.rollout"]
    steps = [e for e in events if e[0] == "vector.step"]
    assert all(block[1] <= s[1] and s[2] <= block[2] and s[3] == block[3] for s in steps)
    for name, start, end, thread in events:
        if name in STEP_SPANS or name == "mujoco.contact_wrenches":
            assert any(s[1] <= start and end <= s[2] and s[3] == thread for s in steps), name
    if wrenches:
        inside = [e for e in events if e[0].startswith("func.")]
        for name, start, end, _ in events:
            if name == "mujoco.contact_wrenches":
                assert [f[0] for f in inside if f[1] <= start and end <= f[2]] in (["func.observation"],
                                                                                    ["func.reward"])


def test_a_train_step_records_the_trainer_spans():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        train_step()
    found = counts(ranges(prof))
    assert found["ppo.policy"] == PPO.rollout_steps
    assert found["ppo.env_step"] == PPO.rollout_steps
    assert found["func.transition"] == PPO.rollout_steps
    assert found["ppo.backward"] == PPO.num_minibatches * PPO.update_epochs
    for name in ("ppo.rollout", "ppo.advantages", "ppo.update"):
        assert found[name] == 1, name
    assert found["vector.step"] == 0  # the trainer steps the functional env, not the vector env


def test_spans_change_no_value():
    _, plain = vector_env("Ant-v5").rollout(T)
    env = vector_env("Ant-v5")
    with profile(activities=[ProfilerActivity.CPU]):
        _, traced = env.rollout(T)
    for a, b in zip(plain[:4], traced[:4]):
        assert torch.equal(a, b)
    state, metrics = train_step()
    with profile(activities=[ProfilerActivity.CPU]):
        traced_state, traced_metrics = train_step()
    for key in metrics:
        assert torch.equal(metrics[key], traced_metrics[key]), key
    for a, b in zip(state.policy.parameters(), traced_state.policy.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(state.obs, traced_state.obs)
