"""The sharded paths on the card: one NCCL rank a card, each rank a spawned
process. A one-rank mesh's sharded HalfCheetah steps equal the unsharded
env's in every bit, each step one launch of the articulated kernel on the
rank's rows, and ``dryrun_multichip(1)`` prints its three legs. Every test
needs a CUDA device and skips without one. The file imports no JAX, so on a
machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_parallel_gpu.py
"""

import pytest
import torch

from gymnasium_tpu_torch.parallel import launch
from tests import torch_parallel_scenarios as sc

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_one_rank_sharded_half_cheetah_equals_unsharded_in_every_bit(cuda):
    (got,) = launch.run_ranks(sc.cuda_cheetah, 1, device="cuda", timeout=300)
    assert got["same"] and all(got["same"])
    # 12 steps of the sharded env and 12 of the plain one
    assert got["launches"] == 24


def test_dryrun_multichip_on_one_nccl_rank(cuda):
    (text,) = launch.run_ranks(sc.cuda_dryrun, 1, device="cuda", timeout=300)
    lines = text.splitlines()
    assert [line.split("]")[0] for line in lines] == ["[dryrun leg 1", "[dryrun leg 2", "[dryrun leg 3"]
    assert all(line.endswith("ok") for line in lines) and "articulated kernel" in lines[1]
