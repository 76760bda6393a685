"""The port's PPO train step on HalfCheetah with the wrapper stack, against JAX's.

The continuous-action counterpart of ``tests/test_torch_ppo.py``, at the
sizes of ``tests/train/test_ppo_learns.py::test_ppo_with_functional_wrappers_halfcheetah``:
NormalizeObservation, NormalizeReward and EpisodeStatistics, 8 envs, 8
steps. Both sides reset to one fixed numpy batch, start from the JAX
weights, and the port takes the JAX trainer's N(0, 1) action noise. The
port's transition is the articulated kernel's plain twin (on the CPU), the
JAX one its vmapped engine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.half_cheetah import HalfCheetahFunctional as JaxHalfCheetah
from gymnasium_tpu.train import ppo as jppo
from gymnasium_tpu.wrappers import func as jfw
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.train.policy import wrapper_states_from_jax
from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward
from tests.test_torch_ppo import assert_params_close, jax_keys, port_state_from_jax

N, T, NU = 8, 8, 6
CONFIG = dict(num_envs=N, rollout_steps=T, hidden_sizes=(32, 32), num_minibatches=2, update_epochs=1,
              max_episode_steps=50)
# The twin and the JAX engine agree to 6e-8 in q and 2.4e-6 in qd a step
# (ROADMAP §3), and the normalised observation's std is about 1, so the
# observations the policy sees agree to a few 1e-6 (2.5e-6 measured after
# the step); everything computed from them is held to 1e-5.
TOL = {"rtol": 1e-5, "atol": 1e-5}
_rng = np.random.default_rng(0)
Q0 = _rng.uniform(-0.1, 0.1, (N, 9)).astype(np.float32)
QD0 = (0.1 * _rng.standard_normal((N, 9))).astype(np.float32)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and the suite runs several
    workers at once, whose thread pools would otherwise contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class _JaxFixedReset(JaxHalfCheetah):
    def initial_batched(self, rng, n, params=None):
        qpos = jnp.asarray(self._init_qpos, jnp.float32) + jnp.asarray(Q0[:n])
        return {"qpos": qpos, "qvel": jnp.asarray(QD0[:n]), "prev_x": qpos[:, 0]}


class _TorchFixedReset(HalfCheetahFunctional):
    def initial_batched(self, rng, n, params=None):
        qpos = torch.as_tensor(self._init_qpos, dtype=torch.float32) + torch.from_numpy(Q0[:n])
        return {"qpos": qpos, "qvel": torch.from_numpy(QD0[:n]), "prev_x": qpos[:, 0]}


def _jax_noise(jstate):
    """The N(0, 1) action noise of the JAX step, checked against its sampler."""
    act_keys, perms = jax_keys(jstate, CONFIG)
    log_std = jstate.params["log_std"]
    noise = []
    for k_act in act_keys:
        draw = jax.random.normal(k_act, (N, NU))
        action, _ = jppo._sample_action(k_act, jnp.zeros((N, NU)), log_std, True)
        np.testing.assert_array_equal(np.asarray(action), np.asarray(jnp.exp(log_std) * draw))
        noise.append(np.asarray(draw))
    return np.stack(noise), perms


def test_wrapped_half_cheetah_train_step_matches_jax():
    jwrappers = (jfw.NormalizeObservation(), jfw.NormalizeReward(), jfw.EpisodeStatistics())
    twrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    jcfg = jppo.PPOConfig(**CONFIG, compute_dtype=jnp.float32)
    tcfg = ppo.PPOConfig(**CONFIG, compute_dtype=torch.float32)
    jenv, tenv = _JaxFixedReset(), _TorchFixedReset()
    jstate, env_params, tx = jppo.init_ppo(jenv, jcfg, jax.random.PRNGKey(0), wrappers=jwrappers)
    jnew, jmetrics = jax.jit(jppo.make_train_step(jenv, jcfg, env_params, tx, wrappers=jwrappers))(jstate)
    noise, perms = _jax_noise(jstate)

    tstate, tparams = ppo.init_ppo(tenv, tcfg, wrappers=twrappers, device="cpu")
    tstate = port_state_from_jax(tstate, jstate, torch.float32)
    assert tstate.policy.continuous and tstate.policy.log_std.shape == (NU,)
    # the initial wrapper states equal JAX's; the step starts from the JAX ones
    np.testing.assert_allclose(tstate.obs.numpy(), np.asarray(jstate.obs), rtol=1e-6, atol=1e-6)
    carried = wrapper_states_from_jax(jstate.env_carry.wrappers)
    for got, want in zip(tstate.env_carry.wrappers[0], carried[0]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    tstate = tstate._replace(env_carry=tstate.env_carry._replace(wrappers=carried))

    draws = ppo.PPODraws(torch.from_numpy(noise), torch.from_numpy(perms).long())
    tnew, tmetrics = ppo.make_train_step(tenv, tcfg, tparams, wrappers=twrappers)(tstate, draws=draws)

    for key in ("loss", "reward_per_step", "mean_value"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), **TOL, err_msg=key)
    assert int(tmetrics["episodes_finished"]) == int(jmetrics["episodes_finished"]) == 0
    (t_obs, t_rew, t_eps), (j_obs, j_rew, j_eps) = tnew.env_carry.wrappers, jnew.env_carry.wrappers
    for label, got, want in (
        ("obs mean", t_obs.mean, j_obs.mean),
        ("obs var", t_obs.var, j_obs.var),
        ("return var", t_rew.rms.var, j_rew.rms.var),
        ("return mean", t_rew.rms.mean, j_rew.rms.mean),
        ("accumulated", t_rew.accumulated, j_rew.accumulated),
        ("episode return", t_eps.episode_return, j_eps.episode_return),
    ):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=label)
    assert float(t_obs.count) == float(j_obs.count) == np.float32(1e-4) + N * (1 + T)
    assert float(t_rew.rms.count) == float(j_rew.rms.count)
    np.testing.assert_array_equal(t_eps.episode_length.numpy(), np.asarray(j_eps.episode_length))
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), **TOL)
    assert_params_close(tnew.policy, jnew.params, TOL)
    assert not torch.equal(tnew.policy.log_std.detach(), tstate.policy.log_std.new_zeros(NU))
