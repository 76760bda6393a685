"""The port's five examples (``examples/torch_*.py``) run end to end on the
CPU at a tiny size, through the same ``main`` their command lines call (the
sharded rollout through its command line: its ranks are spawned processes,
which import the script as the main module)."""

import importlib.util
import os
import subprocess
import sys
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


def test_sharded_rollout_runs_two_gloo_ranks():
    root = EXAMPLES.parent
    out = subprocess.run([sys.executable, str(EXAMPLES / "torch_sharded_rollout.py"), "--device", "cpu",
                          "--ranks", "2", "--steps", "32"], cwd=root, env={**os.environ, "PYTHONPATH": str(root)},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.splitlines()
    assert sorted(line for line in lines if line.startswith("rank ")) == [
        f"rank {r}: obs shard (32, 64, 4) of (32, 128, 4), placements (Shard(dim=1), Replicate())" for r in (0, 1)]
    assert lines[-1] == "rolled out 128x32 steps across 2 ranks"
