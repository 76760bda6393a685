"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so on a machine without it run::

    python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import collections

import pytest
import torch

from chip_smoke import (
    ART_ENVS,
    MJCF_CHAIN_XML,
    MJCF_FRAME_SKIP,
    articulated_env,
    articulated_states,
    compare_articulated_with_twin,
    compare_car_racing_with_cpu,
    compare_classic_with_cpu,
    compare_planar_with_twin,
    compare_ppo_with_cpu,
    compare_rollout_with_twin,
    compare_swimmer_with_cpu,
    compare_terrain_with_twin,
    planar_states,
    walker_env,
    walker_states,
)
from gymnasium_tpu_torch.envs.dynamics.lunar_lander import lander_step
from gymnasium_tpu_torch.ops import articulated_step as art
from gymnasium_tpu_torch.ops import cartpole_rollout as cr
from gymnasium_tpu_torch.ops import planar_step as pl
from tools.port_articulated_probe import layout
from tools.port_planar_probe import unrolled_step

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


def test_ragged_batch_lanes_equal_the_same_lanes_of_a_full_batch(cuda):
    """N=100 leaves the last block part empty; a lane's draws depend on
    (env, step) alone, so its outputs are those of the same lane at N=4096."""
    state, steps, prev_done = _inputs(4096, cuda, seed=2)
    full = cr.cartpole_rollout_fused(state, steps, prev_done, 7, 700)
    part_in = (state[:, :100].contiguous(), steps[:100].contiguous(), prev_done[:100].contiguous())
    part = cr.cartpole_rollout_fused(*part_in, 7, 700)
    torch.cuda.synchronize()
    lanes = [full[0][:, :100], full[1][:100], full[2][:100], full[3][..., :100], *(x[:, :100] for x in full[4:])]
    for got, want in zip(part, lanes):
        assert torch.equal(got, want)
    max_err, _, _ = compare_rollout_with_twin(*part_in, 7, part)
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


@pytest.mark.parametrize("robot, n", [("half_cheetah", 1000), ("ant", 333)]
                         + [(robot, 333) for robot in ART_ENVS if robot not in ("half_cheetah", "ant")])
def test_articulated_kernel_matches_twin(cuda, robot, n):
    """One call of the robot's env's ``frame_skip`` substeps, at a batch that
    leaves the last block ragged: equal to the twin in every bit,
    deterministic."""
    step = art.fused_step(robot, articulated_env(robot).frame_skip)
    inputs = articulated_states(step.model, n, cuda, seed=3)
    before = art.launches[step.build_name]
    compare_articulated_with_twin(step, *inputs)
    assert art.launches[step.build_name] == before + 2


def test_ant_vector_env_launches_the_kernel_once_a_step(cuda):
    from gymnasium_tpu_torch.envs.mujoco import AntFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(AntFunctional(), 256, max_episode_steps=1000, device=cuda)
    env.reset(seed=0)
    before = dict(art.launches)
    carry, traj = env.rollout(6)
    torch.cuda.synchronize()
    assert art.launches - collections.Counter(before) == {"articulated_ant_fs5": 6}
    assert traj.obs.shape == (6, 256, 105) and bool(torch.isfinite(traj.obs).all())


@pytest.mark.parametrize("parts, groups", [(1, 4), (2, 3), (8, 2)])
def test_articulated_layouts_give_the_same_bits(cuda, parts, groups):
    """One thread an env, and warp-specialised layouts whose last block holds
    groups past the batch's end (N=1000), against the shipped layout: each a
    copy of the step carrying the generator's text for its layout."""
    step = art.fused_step("half_cheetah", 5)
    other = layout(step, parts, groups)
    inputs = articulated_states(step.model, 1000, cuda, seed=6)
    for a, b in zip(other(*inputs), step(*inputs)):
        torch.cuda.synchronize()
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert art.launches[other.build_name] >= 1


def test_articulated_kernel_takes_strided_inputs(cuda):
    step = art.fused_step("half_cheetah", 5)
    q, qd, ctrl = articulated_states(step.model, 256, cuda, seed=4)
    strided = ctrl.t().contiguous().t()  # the same values, not contiguous
    assert not strided.is_contiguous()
    out = step(q, qd, strided)
    ref = step(q, qd, ctrl)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


@pytest.mark.parametrize("n", [1000, 4096])
def test_planar_kernel_matches_twin(cuda, n):
    """One call of both substeps on the mixed lander inputs (the last block
    ragged at 1000); within the same-program tolerance of the twin, flags
    exact, deterministic, and every side of the solver reached."""
    step = lander_step(-10.0)
    inputs = planar_states(n, cuda, seed=3)
    before = pl.launches[step.build_name]
    result = compare_planar_with_twin(step, inputs)
    assert pl.launches[step.build_name] == before + 2
    assert result["flag_mismatches"] == 0


def test_planar_rolled_kernel_gives_the_unrolled_bits(cuda):
    """The kernel (solver iterations as loops, one sincosf an angle) against
    the first port's program, unrolled with sinf and cosf, at the workload's N."""
    step = lander_step(-10.0)
    unrolled = unrolled_step(step)
    inputs = planar_states(4096, cuda, seed=5)
    for a, b in zip(step(*inputs), unrolled(*inputs)):
        torch.cuda.synchronize()
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b)
    assert pl.launches[unrolled.build_name] >= 1


def test_planar_kernel_takes_strided_inputs(cuda):
    step = lander_step(-10.0)
    bodies, ext, terrain, jimp, cimp = planar_states(256, cuda, seed=4)
    strided = [x.transpose(0, -1).contiguous().transpose(0, -1) for x in (bodies, terrain, cimp)]
    assert not any(x.is_contiguous() for x in strided)
    out = step(strided[0], ext, strided[1], jimp, strided[2])
    ref = step(bodies, ext, terrain, jimp, cimp)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))


def test_planar_kernel_rejects_mixed_devices(cuda):
    step = lander_step(-10.0)
    bodies, ext, terrain, jimp, cimp = planar_states(8, cuda)
    with pytest.raises(ValueError):
        step(bodies, ext, terrain.cpu(), jimp, cimp)


def test_ppo_half_cheetah_train_step_matches_cpu(cuda):
    """A float32 HalfCheetah train step (wrapper stack, injected draws) at
    N=256: the kernel's rollout on the card against the twin's on the CPU."""
    before = art.launches["articulated_half_cheetah_fs5"]
    allow_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        errs = compare_ppo_with_cpu(cuda)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = allow_tf32
    assert art.launches["articulated_half_cheetah_fs5"] == before + 16
    # compare_ppo_with_cpu raises past PPO_CHECK_TOL (relative and absolute)
    assert set(errs) >= {"loss", "obs", "parameters"}


@pytest.mark.parametrize("name", ["frozenlake8x8", "pendulum_v1"])
def test_classic_env_on_the_card_matches_cpu(cuda, name):
    """Eight autoresetting steps at N=4096 with the same draws and actions:
    FrozenLake8x8's states, rewards and flags equal the CPU's, Pendulum's
    agree within 1e-5 relative. The path launches no kernel of the port."""
    before = (cr.launches, dict(art.launches), dict(pl.launches))
    result = compare_classic_with_cpu(cuda, name)
    assert (cr.launches, dict(art.launches), dict(pl.launches)) == before
    # compare_classic_with_cpu raises past CLASSIC_CHECK_TOL
    assert result["episode_ends"] > 0
    assert (result["tolerance"] is None) == (name == "frozenlake8x8")


@pytest.mark.parametrize("which", ["swimmer_fs1", "mjcf"])
def test_swimmer_and_mjcf_kernels_match_twin(cuda, tmp_path, which):
    """Swimmer's substep at ``frame_skip=1`` and the kernel generated for a
    model compiled from XML, at a ragged N: equal to the twin in every bit,
    each counted under its own build."""
    if which == "mjcf":
        path = tmp_path / "chain.xml"
        path.write_text(MJCF_CHAIN_XML)
        step = art.fused_step(str(path), MJCF_FRAME_SKIP)
        assert step.build_name.startswith("articulated_xml_chain_")
    else:
        step = art.fused_step("swimmer", 1)
    before = dict(art.launches)
    compare_articulated_with_twin(step, *articulated_states(step.model, 333, cuda, seed=3))
    assert art.launches - collections.Counter(before) == {step.build_name: 2}


def test_swimmer_vector_env_launches_the_kernel_four_times_a_step(cuda):
    from gymnasium_tpu_torch.envs.mujoco import SwimmerFunctional
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(SwimmerFunctional(), 256, max_episode_steps=1000, device=cuda)
    env.reset(seed=0)
    before = dict(art.launches)
    carry, traj = env.rollout(3)
    torch.cuda.synchronize()
    assert art.launches - collections.Counter(before) == {"articulated_swimmer_fs1": 12}
    assert traj.obs.shape == (3, 256, 8) and bool(torch.isfinite(traj.obs).all())


def test_swimmer_on_the_card_matches_cpu(cuda):
    """Eight autoresetting Swimmer steps at N=1024, the kernel on the card
    and the twin on the CPU, with the same draws and actions: within 1e-4
    relative."""
    result = compare_swimmer_with_cpu(cuda, n=1024)
    assert result["episode_ends"] > 0


def test_car_racing_on_the_card_matches_cpu(cuda):
    """Eight autoresetting CarRacing steps at N=64 with the same draws and
    actions: visits and flags equal, the car within 1e-4 relative, frames
    and road mask equal but at edge pixels. No kernel of the port runs."""
    before = (cr.launches, dict(art.launches), dict(pl.launches))
    result = compare_car_racing_with_cpu(cuda)
    assert (cr.launches, dict(art.launches), dict(pl.launches)) == before
    assert result["episode_ends"] > 0 and result["max_edge_pixel_share"] < 0.01


@pytest.mark.parametrize("n", [333, 4096])
def test_walker_planar_kernel_matches_twin(cuda, n):
    """The walker's build (four ticks, per-env motors, the heightfield read
    by index, the bounded sub-pull) equals its twin in every bit, with lanes
    on both sides of the clamp, at a ragged N and the workload's."""
    from gymnasium_tpu_torch.envs.box2d.bipedal_walker import walker_solver

    step = walker_solver()
    before = pl.launches[step.build_name]
    result = compare_planar_with_twin(step, walker_states(n, cuda, seed=6))
    assert pl.launches[step.build_name] == before + 2
    assert result["bit_equal"] and result["branch_lanes"]["clamped_joint_pull"] > 0


@pytest.mark.parametrize("n", [333, 4096])
def test_walker_terrain_kernel_matches_twin(cuda, n):
    from gymnasium_tpu_torch.ops import walker_terrain as wt

    before = wt.launches
    assert compare_terrain_with_twin(n, cuda)["bit_equal"]
    assert wt.launches == before + 4


def test_bipedal_vector_env_launches_two_walker_kernels_and_a_terrain_kernel_a_step(cuda):
    from gymnasium_tpu_torch.envs.box2d.bipedal_walker import walker_solver
    from gymnasium_tpu_torch.ops import walker_terrain as wt
    from gymnasium_tpu_torch.vector import TorchVectorEnv

    env = TorchVectorEnv(walker_env(True), 256, max_episode_steps=2000, device=cuda)
    env.reset(seed=0)
    before, terrain_before = dict(pl.launches), wt.launches
    carry, traj = env.rollout(3)
    torch.cuda.synchronize()
    assert pl.launches - collections.Counter(before) == {walker_solver().build_name: 6}
    assert wt.launches == terrain_before + 3
    assert traj.obs.shape == (3, 256, 24) and bool(torch.isfinite(traj.obs).all())
