"""The port's PPO trainer learns CartPole, as the JAX trainer's tests require.

Mirrors ``tests/train/test_ppo_learns.py`` at its thresholds and seed 0, and
its determinism test. These need no JAX: the parity with the JAX train step
is ``tests/test_torch_ppo.py``'s.
"""

import pytest
import torch

from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.wrappers.func import NormalizeObservation, NormalizeReward


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and the suite runs several
    workers at once, whose thread pools would otherwise contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_train_step_deterministic():
    """Mirrors tests/train/test_ppo_learns.py::test_ppo_train_step_deterministic."""
    config = ppo.PPOConfig(num_envs=16, rollout_steps=16, hidden_sizes=(16,), num_minibatches=2,
                           update_epochs=1, max_episode_steps=64)
    outs = []
    for _ in range(2):
        state, params = ppo.init_ppo(CartPoleFunctional(), config, seed=3, device="cpu")
        state, metrics = ppo.make_train_step(CartPoleFunctional(), config, params)(state)
        outs.append((float(metrics["reward_per_step"]), float(metrics["loss"]),
                     [p.detach().clone() for p in state.policy.parameters()]))
    assert outs[0][:2] == outs[1][:2]
    assert all(torch.equal(a, b) for a, b in zip(outs[0][2], outs[1][2]))


LEARN = dict(num_envs=64, rollout_steps=64, hidden_sizes=(32, 32), num_minibatches=4, update_epochs=2,
             max_episode_steps=500)


def test_ppo_improves_cartpole():
    """Mirrors tests/train/test_ppo_learns.py::test_ppo_improves_cartpole, its
    thresholds and seed 0."""
    config = ppo.PPOConfig(**LEARN)
    state, params = ppo.init_ppo(CartPoleFunctional(), config, seed=0, device="cpu")
    step = ppo.make_train_step(CartPoleFunctional(), config, params)
    state, metrics = step(state)
    first = float(metrics["reward_per_step"])
    for _ in range(60):
        state, metrics = step(state)
    last = float(metrics["reward_per_step"])
    assert last > first + 0.015, f"no learning: {first} -> {last}"
    assert last > 0.98, f"final episode length too short: reward/step {last}"


def test_ppo_wrapped_cartpole_still_learns():
    """Mirrors tests/train/test_ppo_learns.py::test_ppo_wrapped_cartpole_still_learns."""
    wrappers = (NormalizeObservation(), NormalizeReward())
    config = ppo.PPOConfig(**LEARN)
    state, params = ppo.init_ppo(CartPoleFunctional(), config, seed=0, wrappers=wrappers, device="cpu")
    step = ppo.make_train_step(CartPoleFunctional(), config, params, wrappers=wrappers)
    state, metrics = step(state)
    first_eps = float(metrics["episodes_finished"])
    for _ in range(60):
        state, metrics = step(state)
    last_eps = float(metrics["episodes_finished"])
    assert last_eps < first_eps * 0.7, f"no learning under wrapped train step: episodes {first_eps} -> {last_eps}"
    assert float(state.env_carry.wrappers[0].count) == pytest.approx(1e-4 + 64 * (1 + 64 * 61), rel=1e-6)
