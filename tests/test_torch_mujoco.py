"""HalfCheetah of the port against the JAX package's, through both vector envs.

Threefry and torch generators draw different numbers, so the same numpy
reset draws are injected into both sides: the port maps them with its own
``reset_values``, the JAX side with the map of its ``initial``
(``jax.random.uniform``'s ``u * (max - min) + min`` and ``noise * normal``).
Then the two trajectories must agree step for step, across an autoreset.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.half_cheetah import HalfCheetahFunctional as JaxHalfCheetah
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.envs.mujoco.locomotion import MujocoFuncEnv
from gymnasium_tpu_torch.functional import tree_map
from gymnasium_tpu_torch.spaces import Box
from gymnasium_tpu_torch.vector import TorchVectorEnv

# the engine tolerance of tests/ops/test_pallas_articulated.py:110-117
Q_TOL = {"rtol": 2e-4, "atol": 2e-3}
QD_TOL = {"rtol": 2e-3, "atol": 0.15}
N, STEPS, TIME_LIMIT = 8, 12, 5
NQ = NV = 9


def _draws(count, seed=0):
    rng = np.random.default_rng(seed)
    return [
        (
            rng.uniform(0.0, 1.0, (N, NQ)).astype(np.float32),
            rng.standard_normal((N, NV)).astype(np.float32),
        )
        for _ in range(count)
    ]


class _JaxInjected(JaxHalfCheetah):
    """JAX HalfCheetah whose batched reset maps injected draws as ``initial`` does."""

    def __init__(self, draws):
        super().__init__()
        self.draws = iter(draws)
        # the env runs eagerly to take new draws each step; its dynamics compile once
        self.transition = jax.jit(super().transition)

    def initial_batched(self, rng, n, params=None):
        u, z = (jnp.asarray(x) for x in next(self.draws))
        noise = self.reset_noise_scale
        lo, hi = jnp.float32(-noise), jnp.float32(noise)
        qpos = jnp.asarray(self._init_qpos) + jnp.maximum(lo, u * (hi - lo) + lo)
        return {"qpos": qpos, "qvel": noise * z, "prev_x": qpos[:, 0]}


class _TorchInjected(HalfCheetahFunctional):
    def __init__(self, draws):
        super().__init__()
        self.draws = iter(draws)

    def initial_batched(self, rng, n, params=None):
        u, z = (torch.from_numpy(x) for x in next(self.draws))
        return self.reset_values(u, z)


def _assert_obs_close(tobs, jobs):
    tobs, jobs = tobs.numpy(), np.asarray(jobs)
    np.testing.assert_allclose(tobs[:, : NQ - 1], jobs[:, : NQ - 1], **Q_TOL)
    np.testing.assert_allclose(tobs[:, NQ - 1 :], jobs[:, NQ - 1 :], **QD_TOL)


def test_half_cheetah_matches_jax_vector_env_across_an_autoreset():
    draws = _draws(STEPS + 1)
    actions = np.random.default_rng(1).uniform(-1, 1, (STEPS, N, 6)).astype(np.float32)
    jenv = JaxVectorEnv(_JaxInjected(draws), num_envs=N, max_episode_steps=TIME_LIMIT, jit=False)
    tenv = TorchVectorEnv(_TorchInjected(draws), N, max_episode_steps=TIME_LIMIT, device="cpu")
    jobs, _ = jenv.reset(seed=0)
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs))  # same draws, same map

    dt = tenv.func_env.dt
    truncations = 0
    for s in range(STEPS):
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(actions[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(actions[s]))
        _assert_obs_close(to, jo)
        # the reward's velocity is a position difference over dt
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=Q_TOL["rtol"], atol=2 * Q_TOL["atol"] / dt)
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
        np.testing.assert_array_equal(tenv.carry.steps.numpy(), np.asarray(jenv.carry.steps))
        np.testing.assert_array_equal(tenv.carry.prev_done.numpy(), np.asarray(jenv.carry.prev_done))
        truncations += int(ttr.sum())
    assert truncations == N * (STEPS // (TIME_LIMIT + 1))
    state, jstate = tenv.carry.state, jenv.carry.state
    np.testing.assert_allclose(state["qpos"].numpy(), np.asarray(jstate["qpos"]), **Q_TOL)
    np.testing.assert_allclose(state["qvel"].numpy(), np.asarray(jstate["qvel"]), **QD_TOL)


def test_masked_reset_keeps_dict_state_lanes():
    env = TorchVectorEnv(HalfCheetahFunctional(), N, max_episode_steps=1000, device="cpu")
    env.reset(seed=0)
    for _ in range(2):
        obs, *_ = env.step(env.action_space.sample_torch(torch.Generator().manual_seed(2)))
    before = tree_map(torch.clone, env.carry.state)
    mask = np.zeros(N, np.bool_)
    mask[::2] = True
    mobs, _ = env.reset(options={"reset_mask": mask})
    keep = torch.from_numpy(~mask)
    for key in ("qpos", "qvel", "prev_x"):
        assert torch.equal(env.carry.state[key][keep], before[key][keep])
        assert not torch.equal(env.carry.state[key][~keep], before[key][~keep])
    assert torch.equal(mobs[keep], obs[keep])
    init = torch.as_tensor(env.func_env._init_qpos, dtype=torch.float32)
    assert float((env.carry.state["qpos"][~keep] - init).abs().max()) <= 0.1 + 1e-6


def test_spaces_and_initial_draws():
    func = HalfCheetahFunctional()
    assert func.dt == pytest.approx(0.05)
    assert isinstance(func.action_space, Box) and func.action_space.shape == (6,)
    assert func.action_space.dtype == np.float32
    assert func.observation_space.shape == (17,)
    state = func.initial_batched(torch.Generator().manual_seed(0), 64)
    assert state["qpos"].shape == (64, 9) and state["qvel"].shape == (64, 9)
    assert torch.equal(state["prev_x"], state["qpos"][:, 0])
    init = torch.as_tensor(func._init_qpos, dtype=torch.float32)
    assert float((state["qpos"] - init).abs().max()) <= 0.1 + 1e-6
    one = func.initial(torch.Generator().manual_seed(0))
    assert one["qpos"].shape == (9,) and one["prev_x"].shape == ()
    assert not func.terminal(state, None).any()


def test_free_root_reset_renormalises_the_quaternion():
    class Ant(MujocoFuncEnv):
        model_name = "ant"

    ant = Ant()
    rng = np.random.default_rng(4)
    u = rng.uniform(0, 1, (16, 15)).astype(np.float32)
    z = rng.standard_normal((16, 14)).astype(np.float32)
    state = ant.reset_values(torch.from_numpy(u), torch.from_numpy(z))
    # the JAX initial's map: uniform noise, then quat / sqrt(sum(quat**2) + 1e-24)
    qpos = jnp.asarray(ant._init_qpos) + (jnp.asarray(u) * jnp.float32(0.2) - jnp.float32(0.1))
    quat = qpos[:, 3:7] / jnp.sqrt(jnp.sum(qpos[:, 3:7] ** 2, axis=1, keepdims=True) + 1e-24)
    want = jnp.concatenate([qpos[:, :3], quat, qpos[:, 7:]], axis=1)
    np.testing.assert_allclose(state["qpos"].numpy(), np.asarray(want), rtol=0, atol=1e-7)
    np.testing.assert_allclose(torch.linalg.norm(state["qpos"][:, 3:7], dim=1).numpy(), 1.0, atol=1e-6)


def test_default_device_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        TorchVectorEnv(HalfCheetahFunctional(), num_envs=4, max_episode_steps=1000)
