"""The centre-of-mass kernels on the card: equal to their plain twins in
every bit, and one launch a call on the Humanoid's paths. Every test needs
a CUDA device and skips without one. The file imports no JAX, so on a
machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_com_kinematics_gpu.py
"""

import pytest
import torch

from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model
from gymnasium_tpu_torch.ops import com_kinematics as ck
from tests.test_torch_contact_wrenches import states

pytestmark = pytest.mark.gpu

ROBOTS = ("humanoid", "humanoidstandup")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bits(x):
    return x.contiguous().view(torch.int32)


@pytest.mark.parametrize("n", [4096, 333, 65536])
@pytest.mark.parametrize("robot", ROBOTS)
def test_kernels_equal_twins_in_every_bit(cuda, robot, n):
    model, _ = load_model(robot)
    q, qd = (torch.from_numpy(x).to(cuda) for x in states(model, n=n, seed=n))
    op = ck.com_kinematics_of(model)
    before = ck.launches[op.build_name]
    vel, x = op.velocity(q, qd), op.mass_center_x(q)
    torch.cuda.synchronize()
    assert ck.launches[op.build_name] == before + 2
    want_vel, want_x = op.reference_velocity(q, qd), op.reference_mass_center_x(q)
    assert vel.shape == want_vel.shape == (n, len(model.bodies.parent), 3) and vel.is_cuda
    assert x.shape == want_x.shape == (n,) and x.is_cuda
    assert float(want_vel.abs().max()) > 0.5  # moving states
    assert torch.equal(_bits(vel), _bits(want_vel))
    assert torch.equal(_bits(x), _bits(want_x))


@pytest.mark.parametrize("name", ["HumanoidFunctional", "HumanoidStandupFunctional"])
def test_each_call_launches_once_and_an_env_step_three_times(cuda, name):
    from gymnasium_tpu_torch.envs import mujoco
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    func = getattr(mujoco, name)()
    build = func._com.build_name
    env = TorchVectorEnv(func, 64, max_episode_steps=1000, device=cuda)
    env.reset(seed=0)
    actions = env.single_action_space.sample_torch(torch.Generator(device=cuda).manual_seed(0), (64,))
    env.step(actions)  # builds and loads the kernels
    torch.cuda.synchronize()
    q, qd = (torch.from_numpy(x).to(cuda) for x in states(func.model, n=64))
    before = ck.launches[build]
    func.com_velocity(q, qd)
    assert ck.launches[build] == before + 1
    func._com_x(q)
    assert ck.launches[build] == before + 2
    env.step(actions)
    torch.cuda.synchronize()
    # the observation's velocities, and the Humanoid's reward's two mass centres
    assert ck.launches[build] == before + 2 + (3 if name == "HumanoidFunctional" else 1)


def test_kernels_refuse_a_non_contiguous_state(cuda):
    model, _ = load_model("humanoid")
    q, qd = (torch.from_numpy(x).to(cuda) for x in states(model, n=64))
    op = ck.com_kinematics_of(model)
    with pytest.raises(ValueError):
        op.velocity(q.t().contiguous().t(), qd)
    with pytest.raises(ValueError):
        op.mass_center_x(q.t().contiguous().t())
