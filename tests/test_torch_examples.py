"""The port's four examples (``examples/torch_*.py``) run end to end on the
CPU at a tiny size, through the same ``main`` their command lines call."""

import importlib.util
from pathlib import Path

import numpy as np
import torch

EXAMPLES = Path(__file__).resolve().parent.parent / "examples"


def example(name: str):
    spec = importlib.util.spec_from_file_location(f"examples_{name}", EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_random_rollout_steps_lunar_lander():
    out = example("torch_random_rollout").main(device="cpu", steps=6)
    assert out["steps"] == 6 and np.isfinite(out["return"])
    assert isinstance(out["obs"], np.ndarray) and out["obs"].shape == (8,)


def test_device_rollout_runs_a_cartpole_batch():
    out = example("torch_device_rollout").main(device="cpu", num_envs=32, steps=12)
    traj = out["traj"]
    assert out["obs_shape"] == (12, 32, 4) and traj.obs.device == torch.device("cpu")
    assert bool(torch.isfinite(traj.obs).all()) and out["env_steps_per_s"] > 0


def test_ppo_cartpole_trains():
    out = example("torch_ppo_cartpole").main(device="cpu", num_envs=16, steps=8, updates=2)
    assert out["updates"] == 2
    assert all(bool(torch.isfinite(p).all()) for p in out["state"].policy.parameters())


def test_ppo_halfcheetah_normalized_keeps_running_statistics():
    out = example("torch_ppo_halfcheetah_normalized").main(device="cpu", num_envs=8, steps=4, updates=2)
    assert out["updates"] == 2 and bool(torch.isfinite(out["metrics"]["loss"]))
    obs_rms = out["state"].env_carry.wrappers[0]
    assert float(obs_rms.count) > 8 and obs_rms.mean.shape == (17,)
