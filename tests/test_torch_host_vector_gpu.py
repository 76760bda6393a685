"""The host vector envs on the card: ``make_vec("HalfCheetah-v5", 4,
vectorization_mode="sync")`` with its sub-envs on CUDA against the same env
with ``device="cpu"`` (each sub-env set to the card's state before each
step, within ``1e-4 * (1 + |cpu|)``), and the ``async`` form in spawned
workers against the sync one, equal in every bit. Every test needs a CUDA
device and skips without one. The file imports no JAX, so on a machine
without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_host_vector_gpu.py
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu_torch as gym

pytestmark = pytest.mark.gpu

N = 4
STEPS = 20
TOL = 1e-4
WAIT = 120.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def actions(steps: int = STEPS) -> np.ndarray:
    return np.random.default_rng(0).uniform(-1.0, 1.0, (steps, N, 6)).astype(np.float32)


def test_sync_on_the_card_agrees_with_the_cpu(cuda):
    card = gym.make_vec("HalfCheetah-v5", N, vectorization_mode="sync")
    cpu = gym.make_vec("HalfCheetah-v5", N, vectorization_mode="sync", device="cpu")
    try:
        assert all(env.unwrapped.device.type == "cuda" for env in card.envs)
        got, want = card.reset(seed=0)[0], cpu.reset(seed=0)[0]
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
        for k, action in enumerate(actions()):
            for c, p in zip(card.envs, cpu.envs):
                p.unwrapped.set_state(*c.unwrapped.get_state())
            got, want = card.step(action), cpu.step(action)
            assert isinstance(got[0], np.ndarray) and got[0].dtype == want[0].dtype
            for a, b in ((got[0], want[0]), (got[1], want[1])):
                assert (np.abs(a - b) <= TOL * (1 + np.abs(b))).all(), f"step {k}"
            assert (got[2] == want[2]).all() and (got[3] == want[3]).all()
    finally:
        card.close()
        cpu.close()


def test_async_spawn_on_the_card_equals_sync(cuda):
    sync = gym.make_vec("HalfCheetah-v5", N, vectorization_mode="sync")
    workers = gym.make_vec("HalfCheetah-v5", N, vectorization_mode="async", vector_kwargs={"context": "spawn"})
    try:
        workers.call_async("device")
        assert all(d.type == "cuda" for d in workers.call_wait(timeout=WAIT))
        workers.reset_async(seed=0)
        got = workers.reset_wait(timeout=WAIT)
        assert np.array_equal(got[0], sync.reset(seed=0)[0])
        for k, action in enumerate(actions()):
            workers.step_async(action)
            got, want = workers.step_wait(timeout=WAIT), sync.step(action)
            assert got[0].tobytes() == want[0].tobytes(), f"step {k}"
            assert got[1].tobytes() == want[1].tobytes(), f"step {k}"
            assert (got[2] == want[2]).all() and (got[3] == want[3]).all()
    finally:
        workers.close(terminate=True)
        sync.close()
