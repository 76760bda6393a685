"""The rest of the port's functional wrappers against the JAX package's.

``FrameStackObservation``, ``TimeAwareObservation``, ``DelayObservation``,
``StickyAction`` and the ``Transform*``, ``Clip*`` and ``Rescale*``
transforms:

- step by step: the same timesteps, reset masks, step counters and actions,
  made with numpy from a seed, through both sides' ``init``,
  ``transform_action`` and ``update``; ``StickyAction``'s repeat draws are
  JAX's, recomputed from the key in its state and fed to the port's map;
- through the vector envs: ``JaxVectorEnv`` and ``TorchVectorEnv`` with the
  same stacks over CartPole and Pendulum, whose reset states are fixed and
  identical on both sides, across autoresets and a masked reset, with
  StickyAction's draws injected the same way.

Observations and rewards hold to ``F32`` where the wrappers only move or
rescale values, and to the two envs' own agreement through the vector envs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.envs.phys2d.pendulum import PendulumFunctional as JaxPendulum
from gymnasium_tpu.functional import EnvCarry as JaxEnvCarry
from gymnasium_tpu.functional import TimeStep as JaxTimeStep
from gymnasium_tpu.spaces import Box as JaxBox
from gymnasium_tpu.spaces import Discrete as JaxDiscrete
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu.wrappers import func as jfw
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.envs.phys2d.pendulum import PendulumFunctional
from gymnasium_tpu_torch.functional import EnvCarry, TimeStep
from gymnasium_tpu_torch.spaces import Box, Discrete
from gymnasium_tpu_torch.vector import TorchVectorEnv
from gymnasium_tpu_torch.wrappers import func as tfw
from tests.test_torch_func_wrappers import N, T, _assert_tree_close, _timesteps

F32 = {"rtol": 1e-6, "atol": 1e-6}
LOW = np.array([-2.0, -1.0, -3.0, -0.5], np.float32)
HIGH = np.array([2.0, 4.0, 3.0, 0.5], np.float32)


def _carries(steps):
    return (JaxEnvCarry(None, jax.random.PRNGKey(0), jnp.asarray(steps), jnp.zeros(N, bool)),
            EnvCarry(None, torch.Generator().manual_seed(0), torch.from_numpy(steps), torch.zeros(N, dtype=torch.bool)))


def _obs_wrappers():
    return {
        "frame_stack_reset": (jfw.FrameStackObservation(3), tfw.FrameStackObservation(3)),
        "frame_stack_zero": (jfw.FrameStackObservation(4, "zero"), tfw.FrameStackObservation(4, "zero")),
        "time_aware": (jfw.TimeAwareObservation(), tfw.TimeAwareObservation()),
        "time_aware_normalized": (jfw.TimeAwareObservation(True, 12), tfw.TimeAwareObservation(True, 12)),
        "delay": (jfw.DelayObservation(2), tfw.DelayObservation(2)),
        "transform_observation": (jfw.TransformObservation(lambda o: jnp.tanh(o) * 3.0),
                                  tfw.TransformObservation(lambda o: torch.tanh(o) * 3.0)),
        "rescale_observation": (jfw.RescaleObservation(LOW, HIGH, -2.0, 3.0),
                                tfw.RescaleObservation(LOW, HIGH, -2.0, 3.0)),
        "transform_reward": (jfw.TransformReward(lambda r: r * r - 1.0), tfw.TransformReward(lambda r: r * r - 1.0)),
        "clip_reward": (jfw.ClipReward(-0.5, 1.25), tfw.ClipReward(-0.5, 1.25)),
        "clip_reward_above": (jfw.ClipReward(max_reward=0.75), tfw.ClipReward(max_reward=0.75)),
    }


@pytest.mark.parametrize("name", list(_obs_wrappers()))
def test_observation_and_reward_wrappers_match_jax_step_by_step(name):
    jw, tw = _obs_wrappers()[name]
    obs, reward, term, trunc, reset = _timesteps(4)
    steps = np.zeros(N, np.int32)
    jcarry, tcarry = _carries(steps)
    jstate, jobs = jw.init(jax.random.PRNGKey(1), jnp.asarray(obs[0]), jcarry)
    tstate, tobs = tw.init(tcarry.rng, torch.from_numpy(obs[0]), tcarry)
    _assert_tree_close(tstate, jstate, "init state")
    _assert_tree_close(tobs, jobs, "init obs")
    for t in range(T):
        # the post-step counter of EnvCarry: 0 on a reset step
        steps = np.where(reset[t], 0, steps + 1).astype(np.int32)
        jcarry, tcarry = _carries(steps)
        jts = JaxTimeStep(jnp.asarray(obs[t + 1]), jnp.asarray(reward[t]), jnp.asarray(term[t]),
                          jnp.asarray(trunc[t]), {})
        tts = TimeStep(torch.from_numpy(obs[t + 1]), torch.from_numpy(reward[t]), torch.from_numpy(term[t]),
                       torch.from_numpy(trunc[t]), {})
        jstate, jts = jw.update(jstate, jts, jnp.asarray(reset[t]), jcarry)
        tstate, tts = tw.update(tstate, tts, torch.from_numpy(reset[t]), tcarry)
        _assert_tree_close(tstate, jstate, f"state after step {t}")
        _assert_tree_close(tuple(tts[:4]), tuple(jts[:4]), f"timestep {t}")


def test_observation_spaces_match_jax():
    box = (JaxBox(LOW, HIGH), Box(LOW, HIGH))
    for jw, tw in ((jfw.FrameStackObservation(3), tfw.FrameStackObservation(3)),
                   (jfw.TimeAwareObservation(), tfw.TimeAwareObservation()),
                   (jfw.TimeAwareObservation(True, 12), tfw.TimeAwareObservation(True, 12)),
                   (jfw.TimeAwareObservation(max_episode_steps=30), tfw.TimeAwareObservation(max_episode_steps=30))):
        js, ts = jw.observation_space(box[0]), tw.observation_space(box[1])
        assert isinstance(ts, Box) and ts.shape == js.shape and ts.dtype == js.dtype
        np.testing.assert_array_equal(ts.low, js.low)
        np.testing.assert_array_equal(ts.high, js.high)


def _action_wrappers():
    return {
        "clip_action": (jfw.ClipAction(LOW, HIGH), tfw.ClipAction(LOW, HIGH)),
        "rescale_action": (jfw.RescaleAction(LOW, HIGH), tfw.RescaleAction(LOW, HIGH)),
        "rescale_action_range": (jfw.RescaleAction(LOW, HIGH, -4.0, 0.5), tfw.RescaleAction(LOW, HIGH, -4.0, 0.5)),
        "transform_action": (jfw.TransformAction(lambda a: a * 0.5 + 0.25), tfw.TransformAction(lambda a: a * 0.5 + 0.25)),
    }


@pytest.mark.parametrize("name", list(_action_wrappers()))
def test_action_transforms_match_jax(name):
    jw, tw = _action_wrappers()[name]
    actions = np.random.default_rng(5).uniform(-6.0, 6.0, (T, N, 4)).astype(np.float32)
    for t in range(T):
        _, ja = jw.transform_action(None, jnp.asarray(actions[t]))
        _, ta = tw.transform_action(None, torch.from_numpy(actions[t]))
        assert ta.dtype == torch.float32
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), **F32)


def _jax_sticky_draws(wstate, n):
    """The uniforms JAX's ``StickyAction.transform_action`` draws from the
    key in its state."""
    _, k = jax.random.split(wstate.rng)
    return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))


@pytest.mark.parametrize("space", ["discrete", "box"])
def test_sticky_action_matches_jax_with_injected_draws(space):
    jspace, tspace = (JaxDiscrete(3), Discrete(3)) if space == "discrete" else (JaxBox(LOW, HIGH), Box(LOW, HIGH))
    jw, tw = jfw.StickyAction(0.4), tfw.StickyAction(0.4)
    assert tw.action_space(tspace) is tspace and jw.action_space(jspace) is jspace
    _, _, _, _, reset = _timesteps(6)
    rng = np.random.default_rng(6)
    jcarry, tcarry = _carries(np.zeros(N, np.int32))
    jstate, _ = jw.init(jax.random.PRNGKey(2), None, jcarry)
    tstate, _ = tw.init(tcarry.rng, torch.zeros((N, 4)), tcarry)
    assert tstate.last_action.dtype == (torch.int32 if space == "discrete" else torch.float32)
    _assert_tree_close((tstate.last_action, tstate.is_first), (jstate.last_action, jstate.is_first), "init")
    repeats = 0
    for t in range(T):
        if space == "discrete":
            action = rng.integers(0, 3, N).astype(np.int32)
        else:
            action = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
        u = _jax_sticky_draws(jstate, N)
        jstate, ja = jw.transform_action(jstate, jnp.asarray(action))
        tstate, ta = tw.apply(tstate, torch.from_numpy(action), u)
        _assert_tree_close(ta, ja, f"action {t}")
        _assert_tree_close(tstate.last_action, jstate.last_action, f"last action {t}")
        repeats += int((ta.numpy() != action).reshape(N, -1).any(1).sum())
        ts = TimeStep(None, None, None, None, {})
        jstate, _ = jw.update(jstate, ts, jnp.asarray(reset[t]), jcarry)
        tstate, _ = tw.update(tstate, ts, torch.from_numpy(reset[t]), tcarry)
        np.testing.assert_array_equal(tstate.is_first.numpy(), np.asarray(jstate.is_first))
    assert repeats > 0


def test_sticky_action_draws_from_the_batch_generator():
    tw = tfw.StickyAction(0.5, action_space=Discrete(2))
    carry = EnvCarry(None, torch.Generator().manual_seed(3), torch.zeros(N, dtype=torch.int32),
                     torch.zeros(N, dtype=torch.bool))
    state, _ = tw.init(carry.rng, torch.zeros((N, 4)), carry)
    assert state.rng is carry.rng
    u = tw.draws(state, N)
    assert u.shape == (N,) and not torch.equal(u, tw.draws(state, N))
    with pytest.raises(ValueError, match="action space"):
        tfw.StickyAction(0.5).init(carry.rng, torch.zeros((N, 4)), carry)
    with pytest.raises(ValueError):
        tfw.StickyAction(1.0)


# -- through the vector envs ---------------------------------------------------

VN = 12
CART_RESET = np.random.default_rng(7).uniform(-0.05, 0.05, size=(VN, 4)).astype(np.float32)
PEND_RESET = np.random.default_rng(8).uniform(-1.0, 1.0, size=(VN, 2)).astype(np.float32)


class _JaxCartPole(JaxCartPole):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(CART_RESET[:n])


class _TorchCartPole(CartPoleFunctional):
    def initial_batched(self, rng, n, params=None):
        return torch.from_numpy(CART_RESET[:n]).to(rng.device)


class _JaxPendulum(JaxPendulum):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(PEND_RESET[:n])


class _TorchPendulum(PendulumFunctional):
    def initial_batched(self, rng, n, params=None):
        return torch.from_numpy(PEND_RESET[:n]).to(rng.device)


class _InjectedSticky(tfw.StickyAction):
    """The port's StickyAction drawing what the JAX env's wrapper draws next."""

    def __init__(self, p, jenv, index):
        super().__init__(p)
        self.jenv, self.index = jenv, index

    def draws(self, wstate, n):
        return _jax_sticky_draws(self.jenv.carry.wrappers[self.index], n)


def _run(jenv, tenv, actions, obs_tol, reward_tol, mask_at):
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **obs_tol)
    ends = 0
    for s, action in enumerate(actions):
        if s == mask_at:
            mask = np.zeros(VN, np.bool_)
            mask[1::3] = True
            jobs, _ = jenv.reset(options={"reset_mask": mask})
            tobs, _ = tenv.reset(options={"reset_mask": mask})
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **obs_tol, err_msg="masked reset")
        # the port first: an injected StickyAction reads the JAX wrapper's key before its step
        to, tr, tte, ttr, _ = tenv.step(action)
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(action))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **obs_tol, err_msg=f"obs {s}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **reward_tol, err_msg=f"reward {s}")
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte), err_msg=f"terminated {s}")
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr), err_msg=f"truncated {s}")
        ends += int((tte | ttr).sum())
    np.testing.assert_array_equal(tenv.carry.env.steps.numpy(), np.asarray(jenv.carry.env.steps))
    return ends


def test_cartpole_vector_envs_match_through_observation_wrappers_and_sticky_action():
    """CartPole under StickyAction, TimeAwareObservation (normalised),
    FrameStackObservation(3, zero padding), DelayObservation(1),
    TransformReward and ClipReward, innermost first."""
    def stack(side, jenv=None):
        w = jfw if side == "jax" else tfw
        sticky = jfw.StickyAction(0.3) if side == "jax" else _InjectedSticky(0.3, jenv, 0)
        return [sticky, w.TimeAwareObservation(True, 10), w.FrameStackObservation(3, "zero"), w.DelayObservation(1),
                w.TransformReward(lambda r: r * 0.5 + 1.0), w.ClipReward(0.0, 1.25)]

    jenv = JaxVectorEnv(_JaxCartPole(), num_envs=VN, max_episode_steps=10, seed=0, wrappers=stack("jax"))
    tenv = TorchVectorEnv(_TorchCartPole(), VN, max_episode_steps=10, device="cpu", wrappers=stack("torch", jenv))
    assert tenv.single_observation_space.shape == jenv.single_observation_space.shape == (3, 5)
    actions = np.random.default_rng(9).integers(0, 2, size=(30, VN)).astype(np.int32)
    # CartPole obs of the two frameworks agree to 2e-5 (tests/test_torch_vector_env.py)
    ends = _run(jenv, tenv, actions, {"rtol": 0, "atol": 2e-5}, F32, mask_at=14)
    assert ends > VN


def test_pendulum_vector_envs_match_through_action_and_rescale_wrappers():
    """Pendulum under RescaleAction onto its torque range, ClipAction,
    TransformAction, RescaleObservation, TransformObservation and
    TimeAwareObservation, innermost first."""
    low, high = np.array([-1.0, -1.0, -8.0], np.float32), np.array([1.0, 1.0, 8.0], np.float32)

    def stack(side):
        w, lib = (jfw, jnp) if side == "jax" else (tfw, torch)
        return [w.RescaleAction(-2.0, 2.0), w.ClipAction(-1.0, 1.0), w.TransformAction(lambda a: a * 1.5),
                w.RescaleObservation(low, high), w.TransformObservation(lambda o: lib.tanh(o)),
                w.TimeAwareObservation()]

    jenv = JaxVectorEnv(_JaxPendulum(), num_envs=VN, max_episode_steps=7, seed=0, wrappers=stack("jax"))
    tenv = TorchVectorEnv(_TorchPendulum(), VN, max_episode_steps=7, device="cpu", wrappers=stack("torch"))
    assert tenv.single_observation_space.shape == jenv.single_observation_space.shape == (4,)
    actions = np.random.default_rng(10).uniform(-1.2, 1.2, size=(16, VN, 1)).astype(np.float32)
    # Pendulum's step of the two frameworks within 1e-5 of max |JAX| + 1e-6 (tests/test_torch_classic_control.py)
    ends = _run(jenv, tenv, actions, {"rtol": 1e-5, "atol": 1e-5}, {"rtol": 1e-5, "atol": 1e-5}, mask_at=9)
    assert ends >= VN
