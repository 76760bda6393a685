"""The port's PPO train step against the JAX package's, on CartPole.

Threefry and torch generators draw different numbers, so both sides run a
CartPole whose reset state is one fixed numpy batch, start from the JAX
weights (``ppo_params_from_jax``), and the port takes the JAX trainer's own
draws through ``draws=``: they are recomputed outside ``jit`` from
``state.rng`` by the key splits of ``gymnasium_tpu/train/ppo.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.functional import make_autoreset_step as jax_autoreset_step
from gymnasium_tpu.functional import vectorize_func_env as jax_vectorize
from gymnasium_tpu.train import ppo as jppo
from gymnasium_tpu.wrappers.func import NormalizeObservation as JaxNormalizeObservation
from gymnasium_tpu.wrappers.func import NormalizeReward as JaxNormalizeReward
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.functional import make_autoreset_step, vectorize_func_env
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.train.policy import ActorCritic, ppo_params_from_jax
from gymnasium_tpu_torch.wrappers.func import NormalizeObservation, NormalizeReward
from tests.test_torch_policy import BF16_TOL

OBS_ATOL = 2e-5  # CartPole obs of the two frameworks (tests/test_torch_vector_env.py)
# float32 values, losses and parameters after one step: sums in another order,
# and Adam's first step moves a parameter by about lr = 3e-4 whatever its gradient
F32_TOL = {"rtol": 1e-5, "atol": 1e-5}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the tensors are small, and the suite runs several
    workers at once, whose thread pools would otherwise contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
N, T, TIME_LIMIT = 16, 16, 10
FIXED_RESET = np.random.default_rng(0).uniform(-0.05, 0.05, size=(N, 4)).astype(np.float32)
CONFIG = dict(num_envs=N, rollout_steps=T, hidden_sizes=(32, 32), num_minibatches=2, update_epochs=2,
              max_episode_steps=TIME_LIMIT)


class _JaxFixedReset(JaxCartPole):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(FIXED_RESET[:n])


class _TorchFixedReset(CartPoleFunctional):
    def initial_batched(self, rng, n, params=None):
        return torch.from_numpy(FIXED_RESET[:n]).to(rng.device)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def jax_keys(jstate, config):
    """The JAX train step's per-step action keys and per-epoch time
    permutations, split from ``state.rng`` as ``gymnasium_tpu/train/ppo.py``
    splits them (:283-284, 268, 353-354)."""
    _, k_roll, k_perm = jax.random.split(jstate.rng, 3)
    act_keys, perms = [], []
    for _ in range(config["rollout_steps"]):
        k_roll, k_act = jax.random.split(k_roll)
        act_keys.append(k_act)
    for _ in range(config["update_epochs"]):
        k_perm, k_t = jax.random.split(k_perm)
        perms.append(np.asarray(jax.random.permutation(k_t, config["rollout_steps"])))
    return act_keys, np.stack(perms)


def jax_draws(jstate, config, logits_fn, sample_fn):
    """The draws of the JAX train step and its trajectory replayed with them
    outside ``jit``.

    ``logits_fn(obs)`` gives the policy's logits at a step, ``sample_fn(key,
    logits)`` checks a draw against the JAX sampler and returns ``(noise,
    action)``. Returns ``(noise (T, N, A), perms (E, T), [(obs, action,
    reward, done) per step], last_obs)``.
    """
    act_keys, perms = jax_keys(jstate, config)
    env_step = jax.jit(config["env_step"])
    carry, obs = jstate.env_carry, jstate.obs
    noise, steps = [], []
    for k_act in act_keys:
        logits = logits_fn(obs)
        draw, action = sample_fn(k_act, logits)
        carry, ts = env_step(carry, action)
        noise.append(np.asarray(draw))
        steps.append((np.asarray(obs), np.asarray(action), np.asarray(ts.reward),
                      np.asarray(ts.terminated | ts.truncated)))
        obs = ts.obs.reshape(obs.shape[0], -1)
    return np.stack(noise), perms, steps, np.asarray(obs)


def gumbel_sample(k_act, logits):
    """JAX's categorical draw and the Gumbel noise it adds."""
    g = jax.random.gumbel(k_act, logits.shape)
    action, _ = jppo._sample_action(k_act, logits, None, False)
    np.testing.assert_array_equal(np.asarray(jnp.argmax(logits + g, axis=-1)), np.asarray(action))
    return g, action


def port_state_from_jax(tstate, jstate, compute_dtype):
    """The port's state with the JAX weights and a fresh Adam over them."""
    policy = ppo_params_from_jax(_host(jstate.params), compute_dtype)
    lr = tstate.optimizer.param_groups[0]["lr"]
    return tstate._replace(policy=policy, optimizer=torch.optim.Adam(policy.parameters(), lr=lr))


def assert_params_close(policy: ActorCritic, jparams, tol):
    for name in ("pi", "v"):
        for layer, p in zip(getattr(policy, name).layers, jparams[name]):
            np.testing.assert_allclose(layer.weight.detach().numpy(), np.asarray(p["w"]).T, **tol, err_msg=name)
            np.testing.assert_allclose(layer.bias.detach().numpy(), np.asarray(p["b"]), **tol, err_msg=name)
    if policy.continuous:
        np.testing.assert_allclose(policy.log_std.detach().numpy(), np.asarray(jparams["log_std"]), **tol)


def jax_gae(values, last_value, reward, done, config):
    """GAE as ``gymnasium_tpu/train/ppo.py:303-318`` computes it."""
    adv = np.zeros_like(values)
    gae, next_value = np.zeros_like(last_value), last_value
    for t in range(values.shape[0] - 1, -1, -1):
        delta = reward[t] + config.gamma * next_value * (1 - done[t]) - values[t]
        gae = delta + config.gamma * config.gae_lambda * (1 - done[t]) * gae
        adv[t] = gae
        next_value = values[t]
    return adv, adv + values


def test_train_step_matches_jax_with_injected_draws():
    jcfg = jppo.PPOConfig(**CONFIG, compute_dtype=jnp.float32)
    tcfg = ppo.PPOConfig(**CONFIG, compute_dtype=torch.float32)
    jenv = _JaxFixedReset()
    jstate, env_params, tx = jppo.init_ppo(jenv, jcfg, jax.random.PRNGKey(0))
    jnew, jmetrics = jax.jit(jppo.make_train_step(jenv, jcfg, env_params, tx))(jstate)

    jax_step = jax_autoreset_step(jax_vectorize(jenv, N), env_params, time_limit=TIME_LIMIT)
    logits_fn = lambda obs: jppo._policy_dist(jstate.params, obs, jcfg, False)[0]  # noqa: E731
    noise, perms, jsteps, jlast = jax_draws(jstate, {**CONFIG, "env_step": jax_step}, logits_fn, gumbel_sample)

    tenv = _TorchFixedReset()
    tstate, tparams = ppo.init_ppo(tenv, tcfg, device="cpu")
    tstate = port_state_from_jax(tstate, jstate, torch.float32)
    np.testing.assert_array_equal(tstate.obs.numpy(), np.asarray(jstate.obs))

    # the trajectory, values, advantages and returns
    tstep = make_autoreset_step(vectorize_func_env(tenv, N), tparams, time_limit=TIME_LIMIT)
    with torch.no_grad():
        _, tlast, traj = ppo._rollout(tstate, tstep, T, False, torch.from_numpy(noise))
        values, adv, returns = ppo._advantages(tstate.policy, traj, tlast, tcfg)
    for t, (obs, action, reward, done) in enumerate(jsteps):
        np.testing.assert_allclose(traj["obs"][t].numpy(), obs, rtol=0, atol=OBS_ATOL, err_msg=f"obs {t}")
        np.testing.assert_array_equal(traj["action"][t].numpy(), action, err_msg=f"action {t}")
        np.testing.assert_array_equal(traj["reward"][t].numpy(), reward)
        np.testing.assert_array_equal(traj["done"][t].numpy(), done)
    np.testing.assert_allclose(tlast.numpy(), jlast, rtol=0, atol=OBS_ATOL)
    all_obs = jnp.concatenate([jnp.asarray(np.stack([s[0] for s in jsteps])), jnp.asarray(jlast)[None]])
    jvalues = np.asarray(jppo._mlp_apply(jstate.params["v"], all_obs, jnp.float32)).squeeze(-1)
    jreward = np.stack([s[2] for s in jsteps])
    jdone = np.stack([s[3] for s in jsteps])
    jadv, jret = jax_gae(jvalues[:-1], jvalues[-1], jreward, jdone, jcfg)
    np.testing.assert_allclose(values.numpy(), jvalues[:-1], **F32_TOL)
    np.testing.assert_allclose(adv.numpy(), jadv, **F32_TOL)
    np.testing.assert_allclose(returns.numpy(), jret, **F32_TOL)
    assert jdone.any(), "no episode ended: the autoreset is not compared"

    # the whole step: metrics and every parameter
    draws = ppo.PPODraws(torch.from_numpy(noise), torch.from_numpy(perms).long())
    tnew, tmetrics = ppo.make_train_step(tenv, tcfg, tparams)(tstate, draws=draws)
    for key in ("loss", "reward_per_step", "mean_value"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), **F32_TOL, err_msg=key)
    assert int(tmetrics["episodes_finished"]) == int(jmetrics["episodes_finished"])
    assert int(tnew.update_count) == int(jnew.update_count) == 1
    np.testing.assert_allclose(tnew.obs.numpy(), np.asarray(jnew.obs), rtol=0, atol=OBS_ATOL)
    assert_params_close(tnew.policy, jnew.params, F32_TOL)


@pytest.mark.parametrize("continuous", [False, True], ids=["discrete", "continuous"])
def test_bf16_loss_and_gradients_match_jax(continuous):
    rng = np.random.default_rng(4)
    obs_dim, act = (4, 2) if not continuous else (17, 6)
    jparams = {
        "pi": jppo._mlp_init(jax.random.PRNGKey(1), (obs_dim, 64, 64, act)),
        "v": jppo._mlp_init(jax.random.PRNGKey(2), (obs_dim, 64, 64, 1)),
    }
    if continuous:
        jparams["log_std"] = jnp.asarray(rng.uniform(-0.5, 0.2, act).astype(np.float32))
        action = rng.normal(size=(8, 16, act)).astype(np.float32)
    else:
        action = rng.integers(0, act, (8, 16))
    mb = (
        rng.normal(size=(8, 16, obs_dim)).astype(np.float32),
        action,
        rng.normal(-1.0, 0.3, (8, 16)).astype(np.float32),
        np.zeros((8, 16), np.float32),
        rng.normal(size=(8, 16)).astype(np.float32),
        rng.normal(size=(8, 16)).astype(np.float32),
    )
    jcfg = jppo.PPOConfig()
    tcfg = ppo.PPOConfig()

    def jloss(params, mb):
        # gymnasium_tpu/train/ppo.py:337-349, composed from the module's own functions
        obs, action, old_logp, old_value, adv, ret = mb
        logits, log_std = jppo._policy_dist(params, obs, jcfg, continuous)
        logp = jppo._log_prob(logits, log_std, action, continuous)
        ratio = jnp.exp(logp - old_logp)
        pg1 = ratio * adv
        pg2 = jnp.clip(ratio, 1 - jcfg.clip_eps, 1 + jcfg.clip_eps) * adv
        pg_loss = -jnp.minimum(pg1, pg2).mean()
        value = jppo._mlp_apply(params["v"], obs, jcfg.compute_dtype).squeeze(-1)
        v_loss = 0.5 * jnp.square(value - ret).mean()
        ent = jppo._entropy(logits, log_std, continuous)
        return pg_loss + jcfg.value_coef * v_loss - jcfg.entropy_coef * ent

    jvalue, jgrads = jax.jit(jax.value_and_grad(jloss))(jparams, tuple(jnp.asarray(x) for x in mb))
    policy = ppo_params_from_jax(_host(jparams))
    assert policy.pi.compute_dtype == torch.bfloat16
    loss = ppo._loss(policy, [torch.from_numpy(np.asarray(x)) for x in mb], tcfg)
    loss.backward()
    tol = {"rtol": BF16_TOL, "atol": BF16_TOL}
    np.testing.assert_allclose(loss.item(), float(jvalue), **tol)
    for name in ("pi", "v"):
        for layer, g in zip(getattr(policy, name).layers, jgrads[name]):
            np.testing.assert_allclose(layer.weight.grad.numpy(), np.asarray(g["w"]).T, **tol, err_msg=name)
            np.testing.assert_allclose(layer.bias.grad.numpy(), np.asarray(g["b"]), **tol, err_msg=name)
    if continuous:
        np.testing.assert_allclose(policy.log_std.grad.numpy(), np.asarray(jgrads["log_std"]), **tol)


def test_clip_by_global_norm_is_optax_rule():
    import optax

    grads = {"a": np.array([3.0, 4.0], np.float32), "b": np.array([[12.0]], np.float32)}
    for max_norm in (0.5, 13.0, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(jax.tree_util.tree_map(jnp.asarray, grads), None)
        params = [torch.nn.Parameter(torch.zeros(2)), torch.nn.Parameter(torch.zeros(1, 1))]
        for p, g in zip(params, grads.values()):
            p.grad = torch.from_numpy(g.copy())
        ppo._clip_by_global_norm(params, max_norm)
        for p, key in zip(params, ("a", "b")):
            np.testing.assert_array_equal(p.grad.numpy(), np.asarray(want[key]))


def test_init_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ppo.init_ppo(CartPoleFunctional(), ppo.PPOConfig(num_envs=4))


def test_rollout_steps_must_cover_the_minibatches():
    with pytest.raises(AssertionError, match="num_minibatches"):
        ppo.make_train_step(CartPoleFunctional(), ppo.PPOConfig(num_envs=4, rollout_steps=2, num_minibatches=4))


def test_wrapped_train_step_matches_jax_wrapper_states():
    """The wrapped CartPole step: the wrapper states after it equal JAX's."""
    jw = (JaxNormalizeObservation(), JaxNormalizeReward())
    tw = (NormalizeObservation(), NormalizeReward())
    jcfg = jppo.PPOConfig(**CONFIG, compute_dtype=jnp.float32)
    tcfg = ppo.PPOConfig(**CONFIG, compute_dtype=torch.float32)
    jenv = _JaxFixedReset()
    jstate, env_params, tx = jppo.init_ppo(jenv, jcfg, jax.random.PRNGKey(2), wrappers=jw)
    jnew, jmetrics = jax.jit(jppo.make_train_step(jenv, jcfg, env_params, tx, wrappers=jw))(jstate)
    from gymnasium_tpu.wrappers.func import wrap_autoreset_step as jax_wrap

    jax_step = jax_wrap(jax_autoreset_step(jax_vectorize(jenv, N), env_params, time_limit=TIME_LIMIT), jw)
    logits_fn = lambda obs: jppo._policy_dist(jstate.params, obs, jcfg, False)[0]  # noqa: E731
    noise, perms, _, _ = jax_draws(jstate, {**CONFIG, "env_step": jax_step}, logits_fn, gumbel_sample)

    tenv = _TorchFixedReset()
    tstate, tparams = ppo.init_ppo(tenv, tcfg, wrappers=tw, device="cpu")
    tstate = port_state_from_jax(tstate, jstate, torch.float32)
    np.testing.assert_allclose(tstate.obs.numpy(), np.asarray(jstate.obs), **F32_TOL)
    draws = ppo.PPODraws(torch.from_numpy(noise), torch.from_numpy(perms).long())
    tnew, tmetrics = ppo.make_train_step(tenv, tcfg, tparams, wrappers=tw)(tstate, draws=draws)
    for key in ("loss", "reward_per_step", "mean_value"):
        np.testing.assert_allclose(float(tmetrics[key]), float(jmetrics[key]), **F32_TOL, err_msg=key)
    (t_obs, t_rew), (j_obs, j_rew) = tnew.env_carry.wrappers, jnew.env_carry.wrappers
    for got, want in ((t_obs.mean, j_obs.mean), (t_obs.var, j_obs.var), (t_rew.rms.var, j_rew.rms.var),
                      (t_rew.accumulated, j_rew.accumulated)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    assert float(t_obs.count) == float(j_obs.count) and float(t_rew.rms.count) == float(j_rew.rms.count)
    assert_params_close(tnew.policy, jnew.params, F32_TOL)
