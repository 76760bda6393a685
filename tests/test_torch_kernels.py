"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on a machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import pytest
import torch

from chip_smoke import compare_rollout_with_twin
from gymnasium_tpu_torch.ops import cartpole_rollout as cr

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(n, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    state = ((torch.rand((4, n), generator=g) * 2 - 1) * 0.05).to(device)
    steps = torch.randint(0, 500, (n,), generator=g, dtype=torch.int32).to(device)
    prev_done = (torch.rand(n, generator=g) < 0.1).to(device)
    return state, steps, prev_done


@pytest.mark.parametrize("n", [64, 200, 1024])
def test_kernel_matches_twin_step_by_step(cuda, n):
    state, steps, prev_done = _inputs(n, cuda)
    before = cr.launches
    out = cr.cartpole_rollout_fused(state, steps, prev_done, 11, 600)
    torch.cuda.synchronize()
    assert cr.launches == before + 1
    max_err, _, _ = compare_rollout_with_twin(state, steps, prev_done, 11, out)
    assert max_err <= 2e-5


def test_bf16_obs_are_f32_obs_rounded(cuda):
    args = (*_inputs(256, cuda), 5, 300)
    f32 = cr.cartpole_rollout_fused(*args)
    bf16 = cr.cartpole_rollout_fused(*args, obs_dtype=torch.bfloat16)
    assert bf16[3].dtype == torch.bfloat16
    assert torch.equal(bf16[3], f32[3].to(torch.bfloat16))
    for i in (0, 1, 2, 4, 5, 6):
        assert torch.equal(bf16[i], f32[i])


def test_short_rollout_equals_twin_exactly_at_reset(cuda):
    """A step from a done lane takes the shared reset draws bit for bit."""
    n = 128
    state, steps, _ = _inputs(n, cuda)
    prev_done = torch.ones(n, dtype=torch.bool, device=cuda)
    kernel = cr.cartpole_rollout_fused(state, steps, prev_done, 9, 1)
    twin = cr.cartpole_rollout_reference(state, steps, prev_done, 9, 1)
    for a, b in zip(kernel, twin):
        assert torch.equal(a, b)


def test_rejects_non_contiguous_state(cuda):
    state = torch.zeros((8, 4), device=cuda).T
    with pytest.raises(ValueError):
        cr.cartpole_rollout_fused(
            state,
            torch.zeros(8, dtype=torch.int32, device=cuda),
            torch.zeros(8, dtype=torch.bool, device=cuda),
            0,
            4,
        )
