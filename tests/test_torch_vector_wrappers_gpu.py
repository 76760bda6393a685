"""The vector wrappers a PPO user runs, on the card: RecordEpisodeStatistics,
ClipAction, NormalizeObservation, NormalizeReward and DictInfoToList over a
``TorchVectorEnv`` of HalfCheetah at ``N`` envs on CUDA, against the same
chain on the CPU from the same reset draws and actions (the CPU's draws
recorded and replayed on the card). The first ``CHECKED`` steps agree: raw
observations and normalised rewards within ``TOL * (1 + |cpu|)``,
normalised observations within twice that over the standard deviation of
the raw observations so far, flags equal (the later steps, an autoreset
among them, take the same draws but are not compared). Over all ``STEPS``
steps on the card the chain hands back numpy float32 observations, numpy rewards and
flags on the card, every action reaching the env lies in [-1, 1], and each
env ends one episode of ``LIMIT`` steps. Every test needs a CUDA device and
skips without one. The file imports no JAX, so on a machine without it
run::

    python -m pytest --noconftest -m gpu tests/test_torch_vector_wrappers_gpu.py
"""

import copy

import numpy as np
import pytest
import torch

import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers.vector as V
from gymnasium_tpu_torch.envs.registration import load_env_creator
from gymnasium_tpu_torch.vector import TorchVectorEnv

pytestmark = pytest.mark.gpu

N = 64
LIMIT = 50
STEPS = 60
CHECKED = 8
TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def chain(env):
    return V.DictInfoToList(V.NormalizeReward(V.NormalizeObservation(V.ClipAction(V.RecordEpisodeStatistics(env)))))


def run(device, reset_draws, actions):
    """The chain over HalfCheetah on ``device`` whose reset draws come from
    ``reset_draws``; returns the base env, the env's actions and each call's
    ``(outputs, raw observation)``."""
    spec = gym.spec("HalfCheetah-v5")
    func = copy.copy(load_env_creator(spec.torch_entry_point)(dict(spec.kwargs) or None))
    func.reset_draws = reset_draws
    base = TorchVectorEnv(func, N, max_episode_steps=LIMIT, device=device)
    reached, env_step = [], base.step
    base.step = lambda a: reached.append(a) or env_step(a)
    env = chain(base)
    calls = [(env.reset(seed=0), base._last_obs.cpu())]
    for action in actions:
        calls.append((env.step(action), base._last_obs.cpu()))
    return base, reached, calls


def test_chain_on_the_card_agrees_with_the_cpu(cuda):
    actions = np.random.default_rng(0).uniform(-2.0, 2.0, (STEPS, N, 6)).astype(np.float32)
    spec = gym.spec("HalfCheetah-v5")
    draw = load_env_creator(spec.torch_entry_point)(dict(spec.kwargs) or None).reset_draws
    recorded = []

    def record(rng, n):
        recorded.append(draw(rng, n))
        return recorded[-1]

    replays = iter(recorded)

    def replay(rng, n):
        return tuple(None if x is None else x.to(cuda) for x in next(replays))

    _, _, cpu = run("cpu", record, actions)
    base, reached, card = run(cuda, replay, actions)
    assert base.device.type == cuda.type
    raw = []
    for k, ((got, got_raw), (want, want_raw)) in enumerate(zip(card[:CHECKED + 1], cpu)):
        assert np.all(np.abs(got_raw - want_raw).numpy() <= TOL * (1 + np.abs(want_raw.numpy()))), f"call {k}: raw obs"
        raw.append(want_raw.numpy().astype(np.float64))
        std = np.concatenate(raw).std(0)
        bound = 2 * TOL * (1 + np.abs(want_raw.numpy())) / np.sqrt(std**2 + 1e-8)
        assert np.all(np.abs(got[0].astype(np.float64) - want[0]) <= bound), f"call {k}: normalised obs"
        if k:
            assert np.all(np.abs(got[1] - want[1]) <= TOL * (1 + np.abs(want[1]))), f"call {k}: reward"
            assert torch.equal(got[2].cpu(), want[2]) and torch.equal(got[3].cpu(), want[3]), f"call {k}: flags"
    episodes = np.zeros(N, np.int64)
    for k, ((obs, reward, term, trunc, infos), _) in enumerate(card[1:]):
        assert isinstance(obs, np.ndarray) and obs.dtype == np.float32 and np.isfinite(obs).all(), f"step {k}"
        assert isinstance(reward, np.ndarray) and term.device.type == trunc.device.type == cuda.type
        for i, info in enumerate(infos):
            if "episode" in info:
                episodes[i] += 1
                assert info["episode"]["l"] == LIMIT
    assert (episodes == 1).all()
    assert len(reached) == STEPS and all(((a >= -1) & (a <= 1)).all() for a in reached)
