"""The registry slice on the card: ``contains`` of CUDA tensors, and a single
env (``FunctionalTorchEnv``, a batch of one) launching the articulated
kernel. Every test needs a CUDA device and skips without one. The file
imports no JAX, so on a machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_registry_gpu.py
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import spaces
from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_contains_of_a_cuda_tensor_answers_as_on_the_host(cuda):
    box = spaces.Box(-1.0, 1.0, (3,))
    for values in ([0.0, 0.5, -1.0], [0.0, 1.5, 0.0], [0.0, 0.0]):
        x = torch.tensor(values)
        assert box.contains(x.to(cuda)) == box.contains(x)
    assert box.contains(torch.tensor([0.0, 0.5, -1.0], device=cuda))
    for value in (1, 2):
        assert spaces.Discrete(2).contains(torch.tensor(value, device=cuda)) == spaces.Discrete(2).contains(
            torch.tensor(value))
    md = spaces.MultiDiscrete([3, 3])
    assert md.contains(torch.tensor([1, 2], device=cuda)) == md.contains(torch.tensor([1, 2]))
    space = spaces.Dict({"u": spaces.Box(0.0, 1.0, (2,)), "k": spaces.Discrete(4), "m": spaces.MultiBinary(3)})
    sample = space.sample_torch(torch.Generator(device=cuda).manual_seed(0), (4096,))
    assert all(leaf.is_cuda for leaf in sample.values())
    assert bool(space.contains_torch(sample))


def test_make_runs_an_episode_on_the_card_through_the_checker(cuda):
    env = gym.make("phys2d/CartPole-v1")
    env.action_space.seed(0)
    obs, _ = env.reset(seed=0)
    assert obs.is_cuda and env.observation_space.contains(obs)
    for _ in range(500):
        obs, _, terminated, truncated, _ = env.step(env.action_space.sample())
        if terminated or truncated:
            break
    assert terminated or truncated


def test_single_env_on_the_card_agrees_with_the_cpu(cuda):
    from gymnasium_tpu_torch.envs.mujoco import HalfCheetahFunctional
    from gymnasium_tpu_torch.ops import articulated_step as art

    card = FunctionalTorchEnv(HalfCheetahFunctional(), device=cuda)
    cpu = FunctionalTorchEnv(HalfCheetahFunctional(), device="cpu")
    card.reset(seed=0)
    cpu.reset(seed=0)
    cpu.state = {k: v.cpu() for k, v in card.state.items()}
    actions = np.random.default_rng(0).uniform(-1, 1, (20, 6)).astype(np.float32)
    art.launches.clear()
    for action in actions:
        got, want = card.step(action), cpu.step(action)
        torch.testing.assert_close(got[0].cpu(), want[0], rtol=1e-4, atol=1e-4)
    assert sum(art.launches.values()) == len(actions)


def test_make_of_a_mujoco_id_steps_on_the_card_one_launch_a_step(cuda):
    from gymnasium_tpu_torch.ops import articulated_step as art

    env = gym.make("Ant-v5")
    assert env.unwrapped.device.type == "cuda"
    obs, _ = env.reset(seed=0)
    cpu = gym.make("Ant-v5", device="cpu")
    cpu.reset(seed=0)
    actions = np.random.default_rng(0).uniform(-1, 1, (10, 8)).astype(np.float32)
    art.launches.clear()
    for action in actions:
        cpu.unwrapped.set_state(*env.unwrapped.get_state())
        got, want = env.step(action), cpu.step(action)
        assert got[0].dtype == np.float64 and got[0].shape == (105,)
        np.testing.assert_allclose(got[0], want[0], rtol=1e-4, atol=1e-4)
        assert got[2] == want[2]
    assert dict(art.launches) == {"articulated_ant_fs5": len(actions)}


@pytest.mark.parametrize("env_id", ["LunarLander-v3", "BipedalWalker-v3"])
def test_make_of_a_box2d_id_steps_on_the_card_as_on_the_cpu(cuda, env_id):
    """Five steps of the host class on the card, each from the card's state
    copied to the CPU env: one launch of the env's planar build a step, and
    the outputs within 1e-4 + 1e-4 |cpu| of the CPU's."""
    from gymnasium_tpu_torch.ops import planar_step as pl
    from gymnasium_tpu_torch.ops import walker_terrain as wt

    env, cpu = gym.make(env_id), gym.make(env_id, device="cpu")
    assert env.unwrapped.device.type == "cuda"
    obs, _ = env.reset(seed=0)
    want, _ = cpu.reset(seed=0)
    assert (np.abs(obs - want) <= 1e-4 + 1e-4 * np.abs(want)).all()
    actions = np.random.default_rng(0).uniform(-1, 1, (5, 4)).astype(np.float32)
    pl.launches.clear()
    wt.launches = 0
    for action in actions:
        action = int(action[0] > 0) * 2 if env_id.startswith("Lunar") else action
        cpu.unwrapped.state = {k: v.cpu() for k, v in env.unwrapped.state.items()}
        cpu.unwrapped.np_random.bit_generator.state = env.unwrapped.np_random.bit_generator.state
        got, want = env.step(action), cpu.step(action)
        assert got[0].dtype == np.float32 and isinstance(got[1], float)
        for a, b in ((got[0], want[0]), (got[1], want[1])):
            assert (np.abs(np.asarray(a) - b) <= 1e-4 + 1e-4 * np.abs(b)).all()
        assert got[2] == want[2]
    assert sum(pl.launches.values()) == len(actions) and len(pl.launches) == 1 and wt.launches == 0
