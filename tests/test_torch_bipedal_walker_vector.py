"""BipedalWalker under ``TorchVectorEnv`` against the JAX package's hooks.

Jitting the JAX walker takes minutes, so the default suite holds the port's
vector env to the JAX module's numpy hooks, chained by the test: before each
env step it reads the env's carry and computes, in float64, the JAX
``walker_step`` of every lane, the reset of the draws the port drew
(``reset_draws``, recorded), the autoreset select, ``observe_state``, the
reward, termination and truncation. Each step starts from the env's own
state, so float32 and float64 part by one step's rounding only. The run
crosses a truncation (a step limit of 3), the autoreset after it and a
masked reset, in normal and hardcore mode. A ``slow`` test holds the port
to ``JaxVectorEnv`` itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.box2d import bipedal_walker as BW
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.box2d import BipedalWalkerFunctional
from gymnasium_tpu_torch.functional import tree_map
from gymnasium_tpu_torch.vector import TorchVectorEnv

N, LIMIT = 8, 3
# One env step in float32 against float64: the JAX kernel test's tolerances
# (tests/ops/test_pallas_planar.py:107-110) on the state; the observation
# scales body rows by at most 1.
STATE_TOL = {"rtol": 0.0, "atol": 2e-4}
OBS_TOL = {"rtol": 0.0, "atol": 2e-4}
# rewards are differences of shaping potentials of about 14
REWARD_TOL = {"rtol": 0.0, "atol": 1e-4}


class _Recording(BipedalWalkerFunctional):
    """The port's walker, keeping the draws of its last batch of resets."""

    def reset_draws(self, rng, n):
        self.drawn = tuple(d.clone() for d in super().reset_draws(rng, n))
        return self.drawn


def _f32(x):
    return np.float32(x)


def reference_reset(draws, hardcore):
    """The JAX module's reset, over numpy, of the port's U[0, 1) draws mapped
    as ``jax.random.uniform(minval, maxval)`` maps them."""
    u, d, k = (x.numpy() for x in draws)
    u = np.maximum(_f32(-1.0), u * _f32(2.0) + _f32(-1.0))
    kick = np.maximum(_f32(-BW.INITIAL_RANDOM), k * _f32(2 * BW.INITIAL_RANDOM) + _f32(-BW.INITIAL_RANDOM))
    n = u.shape[0]
    # lane by lane: the numpy path of the obstacle overlay takes one row
    terrain = np.stack([BW.generate_terrain(np, u[i].astype(np.float64), hardcore, d[i].astype(np.float64))
                        for i in range(len(u))])
    bodies = np.broadcast_to(BW.initial_bodies(np), (n, 5, 6)).copy()
    bodies[:, 0, 3] += kick / BW._HULL_MASS / BW.FPS
    state = {"bodies": bodies, "terrain": terrain, "prev_shaping": np.zeros(n), "done": np.zeros(n, bool),
             "r": np.zeros(n), "cimp": np.zeros((n, len(BW._WORLD.contacts.body), 2))}
    state, _ = BW.walker_step(np, state, np.zeros((n, 4)))
    state["r"], state["done"] = np.zeros(n), np.zeros(n, bool)
    return state


def _numpy(state):
    return {k: v.numpy().astype(np.float64) if v.dtype != torch.bool else v.numpy() for k, v in state.items()}


def _select(mask, a, b):
    return {k: np.where(mask.reshape((-1,) + (1,) * (a[k].ndim - 1)), a[k], b[k]) for k in a}


def _check_state(got, want, label):
    for key in ("bodies", "cimp", "prev_shaping"):
        np.testing.assert_allclose(got[key].numpy(), want[key], **STATE_TOL, err_msg=f"{key} {label}")
    np.testing.assert_allclose(got["terrain"].numpy(), want["terrain"], rtol=0.0, atol=1e-5,
                               err_msg=f"terrain {label}")
    np.testing.assert_array_equal(got["done"].numpy(), want["done"], err_msg=f"done {label}")


@pytest.mark.parametrize("hardcore", [False, True], ids=["normal", "hardcore"])
def test_vector_env_matches_chained_reference_hooks(hardcore):
    func = _Recording({"hardcore": hardcore})
    env = TorchVectorEnv(func, N, max_episode_steps=LIMIT, device="cpu")
    rng = np.random.default_rng(11)
    obs, _ = env.reset(seed=4)
    want = reference_reset(func.drawn, hardcore)
    _check_state(env.carry.state, want, "after reset")
    np.testing.assert_allclose(obs.numpy(), BW.observe_state(np, want), **OBS_TOL)
    assert obs.shape == (N, 24) and obs.dtype == torch.float32

    resets = 0
    for s in range(8):
        if s == 5:  # a masked reset of every third lane; the others keep their state
            mask = np.zeros(N, np.bool_)
            mask[::3] = True
            before = tree_map(torch.clone, env.carry.state)
            mobs, _ = env.reset(options={"reset_mask": mask})
            fresh = reference_reset(func.drawn, hardcore)
            _check_state(env.carry.state, _select(mask, fresh, _numpy(before)), "after the masked reset")
            np.testing.assert_allclose(mobs[mask].numpy(), BW.observe_state(np, fresh)[mask], **OBS_TOL)
            assert not env.carry.steps[torch.from_numpy(mask)].any()
        prev, prev_done, prev_steps = _numpy(env.carry.state), env.carry.prev_done.numpy(), env.carry.steps.numpy()
        action = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
        obs, reward, term, trunc, _ = env.step(action)
        nxt, _ = BW.walker_step(np, prev, action.astype(np.float64))
        state = _select(prev_done, reference_reset(func.drawn, hardcore), nxt) if prev_done.any() else nxt
        steps = np.where(prev_done, 0, prev_steps + 1)
        want_term = state["done"] & ~prev_done
        label = f"step {s}"
        _check_state(env.carry.state, state, label)
        np.testing.assert_allclose(obs.numpy(), BW.observe_state(np, state), **OBS_TOL, err_msg=f"obs {label}")
        np.testing.assert_allclose(reward.numpy(), np.where(prev_done, 0.0, state["r"]), **REWARD_TOL,
                                   err_msg=f"reward {label}")
        np.testing.assert_array_equal(term.numpy(), want_term, err_msg=f"terminated {label}")
        np.testing.assert_array_equal(trunc.numpy(), ~want_term & (steps >= LIMIT) & ~prev_done,
                                      err_msg=f"truncated {label}")
        np.testing.assert_array_equal(env.carry.steps.numpy(), steps)
        resets += int(prev_done.sum())
    assert resets >= N, "no autoreset after the truncations"


@pytest.mark.slow
@pytest.mark.parametrize("hardcore", [False, True], ids=["normal", "hardcore"])
def test_vector_env_matches_jax_vector_env(hardcore):
    """``TorchVectorEnv`` against ``JaxVectorEnv`` (the walker jitted:
    minutes), both resetting every lane to one fixed state made by each
    side's own reset from the same draws, across truncations and their
    autoresets."""
    draws = [torch.from_numpy(x) for x in (np.random.default_rng(12).uniform(0, 1, s).astype(np.float32)
                                           for s in ((N, 200), (N, 200), (N,)))]
    port_reset = BipedalWalkerFunctional({"hardcore": hardcore}).reset_values(*draws)
    jax_reset = {k: jnp.asarray(v) for k, v in reference_reset(draws, hardcore).items()}
    jax_reset = {k: v.astype(jnp.float32) if v.dtype != jnp.bool_ else v for k, v in jax_reset.items()}

    class _JaxFixed(BW.BipedalWalkerFunctional):
        def initial_batched(self, rng, n, params=None):
            return jax_reset

    class _TorchFixed(BipedalWalkerFunctional):
        def initial_batched(self, rng, n, params=None):
            return tree_map(torch.clone, port_reset)

    jenv = JaxVectorEnv(_JaxFixed({"hardcore": hardcore}), num_envs=N, max_episode_steps=4, seed=0)
    tenv = TorchVectorEnv(_TorchFixed({"hardcore": hardcore}), N, max_episode_steps=4, device="cpu")
    jobs, _ = jenv.reset()
    tobs, _ = tenv.reset(seed=0)
    np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), **OBS_TOL)
    rng = np.random.default_rng(13)
    for s in range(10):
        action = rng.uniform(-1, 1, (N, 4)).astype(np.float32)
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(action))
        to, tr, tte, ttr, _ = tenv.step(action)
        # free-running float32 on both sides: chaos grows the gap step by step
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=0.0, atol=2e-3, err_msg=f"obs {s}")
        np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0.0, atol=2e-3, err_msg=f"reward {s}")
        np.testing.assert_array_equal(tte.numpy(), np.asarray(jte))
        np.testing.assert_array_equal(ttr.numpy(), np.asarray(jtr))
