"""The contact-wrench kernel on the card: equal to its plain twin in every
bit, and one launch a call on Ant's vector-env path. Every test needs a
CUDA device and skips without one. The file imports no JAX, so on a machine
without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_contact_wrenches_gpu.py
"""

import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops import articulated_step
from gymnasium_tpu_torch.ops import contact_wrenches as cw
from tests.test_torch_contact_wrenches import ROBOTS, states

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("n", [4096, 333])
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_kernel_equals_twin_in_every_bit(cuda, robot, n):
    model, _ = load_model(robot)
    q, qd = (torch.from_numpy(x).to(cuda) for x in states(model, n=n, seed=n, lower=ROBOTS[robot]))
    op = cw.contact_wrenches_of(model)
    before = cw.launches[op.build_name]
    got = op(q, qd)
    torch.cuda.synchronize()
    assert cw.launches[op.build_name] == before + 1
    want = op.reference(q, qd)
    assert got.shape == want.shape == (n, len(model.bodies.parent), 6) and got.is_cuda
    assert (want.reshape(n, -1).abs().amax(dim=1) > 0).float().mean() >= 0.25
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


def test_an_ant_env_step_launches_the_wrenches_twice_and_the_build_once(cuda):
    from gymnasium_tpu_torch.envs.mujoco import AntFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    func = AntFunctional()
    env = TorchVectorEnv(func, 64, max_episode_steps=1000, device=cuda)
    env.reset(seed=0)
    actions = env.single_action_space.sample_torch(torch.Generator(device=cuda).manual_seed(0), (64,))
    env.step(actions)  # builds and loads both kernels
    torch.cuda.synchronize()
    name = cw.contact_wrenches_of(func.model).build_name
    wrenches, steps = cw.launches[name], dict(articulated_step.launches)
    env.step(actions)
    torch.cuda.synchronize()
    assert cw.launches[name] - wrenches == 2
    assert {k: v - steps.get(k, 0) for k, v in articulated_step.launches.items() if v != steps.get(k, 0)} == {
        func._step.build_name: 1}


def test_kernel_refuses_a_non_contiguous_state(cuda):
    model, _ = load_model("ant")
    q, qd = (torch.from_numpy(x).to(cuda) for x in states(model, n=64))
    with pytest.raises(ValueError):
        cw.contact_wrenches_of(model)(q.t().contiguous().t(), qd)
