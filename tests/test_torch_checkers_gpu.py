"""The env checker and the numpy/torch conversion on the card.

``check_env`` passes over ``make("HalfCheetah-v5")`` on CUDA, each of its
steps one launch of the articulated kernel, and over the functional
``make("phys2d/CartPole-v1")`` on CUDA through the ``"torch"`` branch;
``check_environments_match`` holds HalfCheetah on the card to HalfCheetah
on the CPU, observations and rewards within ``MATCH_ATOL`` and infos with
the same keys (an info's float is held to its bits otherwise);
``NumpyToTorch(..., device="cuda")`` and
its vector form hand out CUDA tensors and take CUDA actions. Every test
needs a CUDA device and skips without one. The file imports no JAX, so on a
machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_checkers_gpu.py
"""

import warnings

import numpy as np
import pytest
import torch

import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.wrappers as W
from gymnasium_tpu_torch.ops import articulated_step as art
from gymnasium_tpu_torch.utils import check_env, check_environments_match

pytestmark = pytest.mark.gpu

MATCH_STEPS = 50
MATCH_ATOL = 1e-3  # chip_smoke.CHECKER_MATCH_ATOL


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_check_env_passes_over_half_cheetah_on_the_card(cuda):
    env = gym.make("HalfCheetah-v5", disable_env_checker=True).unwrapped
    assert env.device.type == "cuda"
    art.launches.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)
    assert sum(art.launches.values()) > 0
    env.close()


def test_check_env_passes_over_a_functional_env_on_the_card(cuda):
    env = gym.make("phys2d/CartPole-v1").unwrapped
    assert env.device.type == "cuda" and env.reset(seed=0)[0].device.type == "cuda"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        check_env(env, skip_render_check=True)


def test_half_cheetah_on_the_card_matches_the_cpu(cuda):
    check_environments_match(gym.make("HalfCheetah-v5"), gym.make("HalfCheetah-v5", device="cpu"),
                             num_steps=MATCH_STEPS, seed=0, atol=MATCH_ATOL, info_comparison="keys-equivalence")


@pytest.mark.parametrize("vector", [False, True], ids=["single", "vector"])
def test_numpy_to_torch_hands_out_cuda_tensors(cuda, vector):
    if vector:
        env = W.vector.NumpyToTorch(gym.make_vec("CartPole-v1", 8, vectorization_mode="sync"), device="cuda")
        action = torch.ones(8, dtype=torch.int64, device=cuda)
    else:
        env = W.NumpyToTorch(gym.make("CartPole-v1"), device="cuda")
        action = torch.tensor(1, device=cuda)
    obs, _ = env.reset(seed=0)
    assert obs.device.type == "cuda" and obs.dtype == torch.float32
    out = env.step(action)
    assert out[0].device.type == "cuda" and bool(torch.isfinite(out[0]).all())
    if vector:
        assert all(x.device.type == "cuda" for x in out[1:4])
    else:
        assert isinstance(out[1], float) and out[2] is False
    env.close()
