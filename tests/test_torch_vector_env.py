"""TorchVectorEnv against JaxVectorEnv, and its reset, rollout and device rules.

Reset draws differ between threefry and torch generators, so the two envs are
compared on a CartPole whose reset state is fixed and identical on both sides.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.spaces import Box, MultiDiscrete
from gymnasium_tpu_torch.vector import AutoresetMode, TorchVectorEnv

OBS_ATOL = 2e-5  # tests/ops/test_pallas_rollout.py:61
N = 32
FIXED_RESET = np.random.default_rng(0).uniform(-0.05, 0.05, size=(N, 4)).astype(np.float32)


class _JaxFixedReset(JaxCartPole):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(FIXED_RESET[:n])


class _TorchFixedReset(CartPoleFunctional):
    def initial_batched(self, rng, n, params=None):
        return torch.from_numpy(FIXED_RESET[:n]).to(rng.device)


def test_trajectories_match_jax_vector_env():
    num_steps = 150
    actions = np.random.default_rng(1).integers(0, 2, size=(num_steps, N))
    jenv = JaxVectorEnv(_JaxFixedReset(), num_envs=N, max_episode_steps=40, seed=0)
    tenv = TorchVectorEnv(_TorchFixedReset(), num_envs=N, max_episode_steps=40, device="cpu")
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))
    ends = 0
    for s in range(num_steps):
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(actions[s], jnp.int32))
        to, tr, tte, ttr, _ = tenv.step(actions[s])
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=OBS_ATOL)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        ends += int((tte | ttr).sum())
    np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
    assert ends > 0


def test_spaces_are_batched():
    env = TorchVectorEnv(CartPoleFunctional(), num_envs=N, device="cpu")
    assert isinstance(env.observation_space, Box) and env.observation_space.shape == (N, 4)
    assert isinstance(env.action_space, MultiDiscrete) and env.action_space.shape == (N,)


def test_masked_partial_reset_keeps_unmasked_lanes():
    env = TorchVectorEnv(CartPoleFunctional(), num_envs=N, max_episode_steps=500, device="cpu")
    env.reset(seed=0)
    for _ in range(3):
        obs, *_ = env.step(np.ones(N, np.int64))
    mask = np.zeros(N, np.bool_)
    mask[::2] = True
    state_before = env.carry.state.clone()
    steps_before = env.carry.steps.clone()
    mobs, _ = env.reset(options={"reset_mask": mask})
    keep = torch.from_numpy(~mask)
    assert torch.equal(env.carry.state[keep], state_before[keep])
    assert torch.equal(env.carry.steps[keep], steps_before[keep])
    assert torch.equal(mobs[keep], obs[keep])
    assert not env.carry.steps[~keep].any()
    assert float(mobs[~keep].abs().max()) <= 0.05
    assert not torch.equal(mobs[~keep], obs[~keep])


@pytest.mark.parametrize(
    "mask, error",
    [
        (np.ones(N - 1, np.bool_), "shape"),
        (np.ones(N, np.int64), "dtype"),
        (np.zeros(N, np.bool_), "at least one True"),
    ],
)
def test_masked_reset_rejects_bad_masks(mask, error):
    env = TorchVectorEnv(CartPoleFunctional(), num_envs=N, device="cpu")
    env.reset()
    with pytest.raises(ValueError, match=error):
        env.reset(options={"reset_mask": mask})


def test_rollout_equals_step_loop():
    def ones(rng, obs):
        return torch.ones(obs.shape[0], dtype=torch.int64)

    a = TorchVectorEnv(CartPoleFunctional(), num_envs=N, max_episode_steps=20, device="cpu")
    b = TorchVectorEnv(CartPoleFunctional(), num_envs=N, max_episode_steps=20, device="cpu")
    a.reset(seed=3)
    b.reset(seed=3)
    carry, traj = a.rollout(60, action_fn=ones)
    assert traj.obs.shape == (60, N, 4) and traj.reward.shape == (60, N)
    for s in range(60):
        obs, reward, term, trunc, _ = b.step(np.ones(N, np.int64))
        assert torch.equal(traj.obs[s], obs)
        assert torch.equal(traj.reward[s], reward)
        assert torch.equal(traj.terminated[s], term)
        assert torch.equal(traj.truncated[s], trunc)
    assert torch.equal(carry.state, b.carry.state)


def test_default_rollout_invariants():
    env = TorchVectorEnv(CartPoleFunctional(), num_envs=N, max_episode_steps=30, device="cpu")
    carry, traj = env.rollout(120)
    done = traj.terminated | traj.truncated
    assert torch.isfinite(traj.obs).all()
    # reward is 0 exactly on the step after a done
    assert torch.equal(traj.reward[1:] == 0, done[:-1])
    assert int(carry.steps.max()) <= 30
    assert traj.truncated.any() and traj.terminated.any()


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVectorEnv(CartPoleFunctional(), num_envs=4)


@pytest.mark.parametrize(
    "kwargs",
    [{"sharding": object()}, {"wrappers": [object()]}, {"autoreset_mode": AutoresetMode.SAME_STEP}],
)
def test_unported_arguments_raise(kwargs):
    with pytest.raises((NotImplementedError, ValueError)):
        TorchVectorEnv(CartPoleFunctional(), num_envs=4, device="cpu", **kwargs)
