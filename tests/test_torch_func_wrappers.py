"""The port's functional wrappers against the JAX package's, step for step.

The same timesteps and reset masks, made with numpy from a seed, go through
both sides' ``init``/``update``; then both vector envs run the same wrapper
stack over a CartPole whose reset state is fixed and identical on both
sides (threefry and torch generators draw different numbers).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.functional import EnvCarry as JaxEnvCarry
from gymnasium_tpu.functional import TimeStep as JaxTimeStep
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu.wrappers import func as jfw
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.functional import EnvCarry, TimeStep
from gymnasium_tpu_torch.spaces import Box
from gymnasium_tpu_torch.train.policy import wrapper_states_from_jax
from gymnasium_tpu_torch.vector import TorchVectorEnv
from gymnasium_tpu_torch.wrappers import func as tfw

# float32 statistics: the two frameworks sum a batch in different orders
F32 = {"rtol": 1e-6, "atol": 1e-6}
N, T = 8, 40


def _timesteps(seed=0):
    """Obs, rewards and flags with NEXT_STEP reset steps: the step after a
    done has reward 0 and no flags, and its reset mask is set."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(0.5, 2.0, (T + 1, N, 4)).astype(np.float32)
    reward = rng.uniform(-1.0, 2.0, (T, N)).astype(np.float32)
    term = rng.uniform(size=(T, N)) < 0.08
    trunc = ~term & (rng.uniform(size=(T, N)) < 0.05)
    reset = np.zeros((T, N), bool)
    for t in range(1, T):
        reset[t] = term[t - 1] | trunc[t - 1]
        reward[t][reset[t]] = 0.0
        term[t] &= ~reset[t]
        trunc[t] &= ~reset[t]
    assert reset.any() and term.any() and trunc.any()
    return obs, reward, term, trunc, reset


def _leaves(tree):
    out = []
    if tree is None:
        return out
    if isinstance(tree, tuple):
        for child in tree:
            out += _leaves(child)
        return out
    if isinstance(tree, dict):
        for key in sorted(tree):
            out += _leaves(tree[key])
        return out
    return [tree.numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)]


def _assert_tree_close(got, want, msg=""):
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want), msg
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, f"{msg}: {g.dtype}{g.shape} vs {w.dtype}{w.shape}"
        if np.issubdtype(g.dtype, np.floating):
            np.testing.assert_allclose(g, w, err_msg=msg, **F32)
        else:
            np.testing.assert_array_equal(g, w, err_msg=msg)


def _drive(pair):
    """Run one wrapper of each side over the timesteps; compare every state
    leaf and output after each call."""
    jw, tw = pair
    obs, reward, term, trunc, reset = _timesteps()
    jcarry = JaxEnvCarry(None, jax.random.PRNGKey(0), jnp.zeros(N, jnp.int32), jnp.zeros(N, bool))
    tcarry = EnvCarry(None, torch.Generator().manual_seed(0), torch.zeros(N, dtype=torch.int32),
                      torch.zeros(N, dtype=torch.bool))
    jstate, jobs = jw.init(jax.random.PRNGKey(1), jnp.asarray(obs[0]), jcarry)
    tstate, tobs = tw.init(tcarry.rng, torch.from_numpy(obs[0]), tcarry)
    _assert_tree_close(tstate, jstate, "init state")
    _assert_tree_close(tobs, jobs, "init obs")
    # from here on both sides start from one state: the JAX one, carried across
    tstate = wrapper_states_from_jax(jstate)
    for t in range(T):
        jts = JaxTimeStep(jnp.asarray(obs[t + 1]), jnp.asarray(reward[t]), jnp.asarray(term[t]),
                          jnp.asarray(trunc[t]), {})
        tts = TimeStep(torch.from_numpy(obs[t + 1]), torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
                       torch.from_numpy(trunc[t]), {})
        jstate, jts = jw.update(jstate, jts, jnp.asarray(reset[t]), jcarry)
        tstate, tts = tw.update(tstate, tts, torch.from_numpy(reset[t]), tcarry)
        _assert_tree_close(tstate, jstate, f"state after step {t}")
        _assert_tree_close(tuple(tts[:4]), tuple(jts[:4]), f"timestep {t}")
        _assert_tree_close(tts.info, jts.info, f"info {t}")
    return tstate


@pytest.mark.parametrize(
    "pair",
    [
        (jfw.NormalizeObservation(), tfw.NormalizeObservation()),
        (jfw.NormalizeReward(gamma=0.97), tfw.NormalizeReward(gamma=0.97)),
        (jfw.EpisodeStatistics(), tfw.EpisodeStatistics()),
    ],
    ids=["normalize_observation", "normalize_reward", "episode_statistics"],
)
def test_wrapper_matches_jax_step_by_step(pair):
    _drive(pair)


def test_rms_matches_jax_and_freezes():
    rng = np.random.default_rng(3)
    batches = [rng.normal(1.0, 3.0, (n, 5)).astype(np.float32) for n in (7, 64, 1)]
    jrms, trms = jfw.rms_init((5,)), tfw.rms_init((5,))
    for batch in batches:
        jrms = jfw.rms_update(jrms, jnp.asarray(batch))
        trms = tfw.rms_update(trms, torch.from_numpy(batch))
        _assert_tree_close(trms, jrms, "rms")
    # the variance is the population variance (jnp.var), not torch.var's default
    assert trms.var.shape == (5,) and trms.count.dtype == torch.float32 and trms.count.dim() == 0
    frozen = tfw._freeze(trms)
    after = tfw.rms_update(frozen, torch.from_numpy(batches[0]))
    for a, b in zip(after[:3], frozen[:3]):
        assert torch.equal(a, b)
    resumed = tfw.rms_update(tfw._freeze(frozen, frozen=False), torch.from_numpy(batches[0]))
    assert float(resumed.count) == float(frozen.count) + 7


def test_normalize_observation_freeze():
    """Mirrors tests/wrappers/test_func_wrappers.py::test_normalize_observation_freeze."""
    obs, reward, term, trunc, _ = _timesteps(1)
    wrapper = tfw.NormalizeObservation()
    carry0 = EnvCarry(None, torch.Generator(), torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.bool))
    wstate, _ = wrapper.init(carry0.rng, torch.from_numpy(obs[0]), carry0)
    frozen = tfw.NormalizeObservation.freeze(wstate)
    ts = TimeStep(torch.from_numpy(obs[1]), torch.from_numpy(reward[0]), torch.from_numpy(term[0]),
                  torch.from_numpy(trunc[0]), {})
    new_state, _ = wrapper.update(frozen, ts, torch.zeros(N, dtype=torch.bool), carry0)
    assert torch.equal(new_state.mean, frozen.mean)
    assert torch.equal(new_state.count, frozen.count)
    rew_state, _ = tfw.NormalizeReward().init(None, None, carry0)
    frozen_rew = tfw.NormalizeReward.freeze(rew_state)
    after, _ = tfw.NormalizeReward().update(frozen_rew, ts, torch.zeros(N, dtype=torch.bool), carry0)
    assert torch.equal(after.rms.count, frozen_rew.rms.count)
    assert not torch.equal(after.accumulated, frozen_rew.accumulated)


def test_episode_stats_to_infos_matches_jax():
    obs, reward, term, trunc, reset = _timesteps(2)
    jw, tw = jfw.EpisodeStatistics(), tfw.EpisodeStatistics()
    jcarry = JaxEnvCarry(None, jax.random.PRNGKey(0), jnp.zeros(N, jnp.int32), jnp.zeros(N, bool))
    tcarry = EnvCarry(None, None, torch.zeros(N, dtype=torch.int32), torch.zeros(N, dtype=torch.bool))
    jstate, _ = jw.init(None, None, jcarry)
    tstate, _ = tw.init(None, None, tcarry)
    ended = 0
    for t in range(T):
        jstate, jts = jw.update(jstate, JaxTimeStep(None, jnp.asarray(reward[t]), jnp.asarray(term[t]),
                                                    jnp.asarray(trunc[t]), {"extra": 1}), jnp.asarray(reset[t]),
                                jcarry)
        tstate, tts = tw.update(tstate, TimeStep(None, torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
                                                 torch.from_numpy(trunc[t]), {"extra": 1}), torch.from_numpy(reset[t]),
                                tcarry)
        want = jfw.episode_stats_to_infos({k: np.asarray(v) for k, v in jts.info.items()})
        got = tfw.episode_stats_to_infos(tts.info)
        assert sorted(got) == sorted(want) and got["extra"] == 1
        if "episode" in want:
            ended += 1
            np.testing.assert_array_equal(got["_episode"], want["_episode"])
            np.testing.assert_allclose(got["episode"]["r"], want["episode"]["r"], **F32)
            np.testing.assert_array_equal(got["episode"]["l"], want["episode"]["l"])
    assert 0 < ended < T


def test_state_per_env_marks_shared_statistics():
    carry = EnvCarry(None, None, torch.zeros(4, dtype=torch.int32), torch.zeros(4, dtype=torch.bool))
    obs = torch.zeros((4, 4))  # an obs width equal to the batch size
    rms, _ = tfw.NormalizeObservation().init(None, obs, carry)
    assert not any(_leaves_bool(tfw.NormalizeObservation().state_per_env(rms, 4)))
    rew, _ = tfw.NormalizeReward().init(None, obs, carry)
    mask = tfw.NormalizeReward().state_per_env(rew, 4)
    assert mask.accumulated is True and not any(_leaves_bool(mask.rms))
    stats, _ = tfw.EpisodeStatistics().init(None, obs, carry)
    assert tfw.EpisodeStatistics().state_per_env(stats, 4) == (True, True)


def _leaves_bool(tree):
    return list(tree) if isinstance(tree, tuple) else [tree]


def test_spaces_through_wrappers():
    env = TorchVectorEnv(CartPoleFunctional(), 4, device="cpu",
                         wrappers=[tfw.NormalizeObservation(), tfw.NormalizeReward()])
    space = env.single_observation_space
    assert isinstance(space, Box) and space.shape == (4,) and np.isinf(space.high).all()
    assert env.single_action_space == CartPoleFunctional().action_space
    with pytest.raises(TypeError, match="FuncWrapper"):
        TorchVectorEnv(CartPoleFunctional(), 4, device="cpu", wrappers=[object()])


# -- through the vector envs ---------------------------------------------------

VN = 16
FIXED_RESET = np.random.default_rng(5).uniform(-0.05, 0.05, size=(VN, 4)).astype(np.float32)
# CartPole obs of the two frameworks agree to 2e-5 (tests/test_torch_vector_env.py);
# normalisation divides by a running std of about 0.1-1
WRAPPED_OBS_ATOL = 2e-4


class _JaxFixedReset(JaxCartPole):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(FIXED_RESET[:n])


class _TorchFixedReset(CartPoleFunctional):
    def initial_batched(self, rng, n, params=None):
        return torch.from_numpy(FIXED_RESET[:n]).to(rng.device)


def _stack(kind):
    if kind == "jax":
        return [jfw.NormalizeObservation(), jfw.NormalizeReward(), jfw.EpisodeStatistics()]
    return [tfw.NormalizeObservation(), tfw.NormalizeReward(), tfw.EpisodeStatistics()]


def _compare_step(jout, tout, s):
    jo, jr, jte, jtr, jinfo = jout
    to, tr, tte, ttr, tinfo = tout
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0, atol=WRAPPED_OBS_ATOL, err_msg=f"obs {s}")
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-5, atol=1e-6, err_msg=f"reward {s}")
    np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
    np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
    np.testing.assert_array_equal(tinfo["_episode"].numpy(), np.asarray(jinfo["_episode"]))
    np.testing.assert_array_equal(tinfo["episode_length"].numpy(), np.asarray(jinfo["episode_length"]))
    np.testing.assert_allclose(tinfo["episode_return"].numpy(), np.asarray(jinfo["episode_return"]),
                               rtol=1e-5, atol=1e-5)


def test_wrapped_vector_envs_match_across_autoresets_and_a_masked_reset():
    steps = 60
    actions = np.random.default_rng(1).integers(0, 2, size=(steps, VN))
    jenv = JaxVectorEnv(_JaxFixedReset(), num_envs=VN, max_episode_steps=15, seed=0, wrappers=_stack("jax"))
    tenv = TorchVectorEnv(_TorchFixedReset(), VN, max_episode_steps=15, device="cpu", wrappers=_stack("torch"))
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=WRAPPED_OBS_ATOL)
    ends = 0
    for s in range(steps):
        if s == steps // 2:
            mask = np.zeros(VN, np.bool_)
            mask[::3] = True
            stats_before = tenv.carry.wrappers[0]
            jobs, _ = jenv.reset(options={"reset_mask": mask})
            tobs, _ = tenv.reset(options={"reset_mask": mask})
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0, atol=WRAPPED_OBS_ATOL)
            # the shared statistics are kept; the per-env leaves restart on reset lanes
            for a, b in zip(tenv.carry.wrappers[0], stats_before):
                assert torch.equal(a, b)
            _assert_tree_close(tenv.carry.wrappers[1:], jenv.carry.wrappers[1:], "wrapper states after masked reset")
            assert not tenv.carry.env.steps[torch.from_numpy(mask)].any()
        jout = jenv.step(jnp.asarray(actions[s], jnp.int32))
        tout = tenv.step(actions[s])
        _compare_step(jout, tout, s)
        ends += int(tout[4]["_episode"].sum())
    np.testing.assert_array_equal(tenv.carry.env.steps.numpy(), np.asarray(jenv.carry.env.steps))
    tw, jw = tenv.carry.wrappers, jenv.carry.wrappers
    np.testing.assert_allclose(tw[0].mean.numpy(), np.asarray(jw[0].mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tw[0].var.numpy(), np.asarray(jw[0].var), rtol=1e-5)
    np.testing.assert_array_equal(tw[0].count.numpy(), np.asarray(jw[0].count))
    np.testing.assert_allclose(tw[1].rms.var.numpy(), np.asarray(jw[1].rms.var), rtol=1e-5)
    assert ends > VN


def test_wrapped_rollout_stacks_info_and_equals_steps():
    def ones(rng, obs):
        return torch.ones(obs.shape[0], dtype=torch.int64)

    a = TorchVectorEnv(CartPoleFunctional(), VN, max_episode_steps=20, device="cpu", wrappers=_stack("torch"))
    b = TorchVectorEnv(CartPoleFunctional(), VN, max_episode_steps=20, device="cpu", wrappers=_stack("torch"))
    a.reset(seed=3)
    b.reset(seed=3)
    carry, traj = a.rollout(50, action_fn=ones)
    assert traj.obs.shape == (50, VN, 4) and traj.info["_episode"].shape == (50, VN)
    for s in range(50):
        obs, reward, term, trunc, info = b.step(np.ones(VN, np.int64))
        assert torch.equal(traj.obs[s], obs) and torch.equal(traj.reward[s], reward)
        assert torch.equal(traj.info["episode_length"][s], info["episode_length"])
    assert torch.equal(carry.wrappers[0].mean, b.carry.wrappers[0].mean)
    ended = traj.info["_episode"]
    assert ended.any() and (traj.info["episode_length"][ended] > 0).all()
