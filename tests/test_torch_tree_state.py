"""A state that is a tree of tensors through the port's autoreset step and
masked reset, against the JAX step on a toy env whose state is a pytree."""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu import functional as jf
from gymnasium_tpu_torch import functional as tf
from gymnasium_tpu_torch.spaces import Box, Discrete
from gymnasium_tpu_torch.vector import TorchVectorEnv


class _JaxTree(jf.FuncEnv):
    """Counts up by the action in ``count``; ``pair`` tracks the step and a
    running sum of squares; terminal at count 4."""

    rng_hooks = frozenset()

    def initial(self, rng, params=None):
        return {"count": jnp.zeros((), jnp.float32), "pair": (jnp.zeros(2, jnp.float32), jnp.ones((), jnp.float32))}

    def transition(self, state, action, rng, params=None):
        count = state["count"] + action
        first, second = state["pair"]
        return {"count": count, "pair": (first + jnp.stack([1.0, count * count]), second * 2.0)}

    def observation(self, state, rng, params=None):
        return jnp.concatenate([state["count"][None], state["pair"][0], state["pair"][1][None]])

    def reward(self, state, action, next_state, rng, params=None):
        return next_state["count"] - state["count"]

    def terminal(self, state, rng, params=None):
        return state["count"] >= 4


class _TorchTree(tf.FuncEnv):
    """Batch-first twin of :class:`_JaxTree`."""

    observation_space = Box(-np.inf, np.inf, (4,), np.float32)
    action_space = Discrete(2)

    def initial(self, rng, params=None):
        return {"count": torch.zeros(()), "pair": (torch.zeros(2), torch.ones(()))}

    def transition(self, state, action, rng, params=None):
        count = state["count"] + action
        first, second = state["pair"]
        return {
            "count": count,
            "pair": (first + torch.stack([torch.ones_like(count), count * count], dim=-1), second * 2.0),
        }

    def observation(self, state, rng, params=None):
        first, second = state["pair"]
        return torch.cat([state["count"][:, None], first, second[:, None]], dim=1)

    def reward(self, state, action, next_state, rng, params=None):
        return next_state["count"] - state["count"]

    def terminal(self, state, rng, params=None):
        return state["count"] >= 4


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


@pytest.mark.parametrize("time_limit", [None, 6])
def test_tree_state_autoreset_matches_jax(time_limit):
    n, num_steps = 8, 24
    actions = np.random.default_rng(3).integers(0, 2, size=(num_steps, n)).astype(np.float32)

    jbatched = jf.vectorize_func_env(_JaxTree(), n)
    jstep = jax.jit(jf.make_autoreset_step(jbatched, time_limit=time_limit))
    jcarry, jobs = jf.make_initial_carry(jbatched, jax.random.PRNGKey(0))

    batched = tf.vectorize_func_env(_TorchTree(), n)
    step = tf.make_autoreset_step(batched, time_limit=time_limit)
    carry, obs = tf.make_initial_carry(batched, torch.Generator())
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jobs))

    resets = 0
    for s in range(num_steps):
        jcarry, jts = jstep(jcarry, jnp.asarray(actions[s]))
        carry, ts = step(carry, torch.from_numpy(actions[s]))
        for got, want in zip(ts[:4], jts[:4]):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(carry.steps.numpy(), np.asarray(jcarry.steps))
        for got, want in zip(_leaves(carry.state), _leaves(jcarry.state)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        resets += int(carry.prev_done.sum())
    assert resets > 0


def test_masked_reset_of_a_tree_state():
    n = 6
    env = TorchVectorEnv(_TorchTree(), n, device="cpu")
    env.reset()
    obs, *_ = env.step(np.ones(n, np.float32))
    obs, *_ = env.step(np.ones(n, np.float32))
    before = tf.tree_map(torch.clone, env.carry.state)
    mask = np.array([True, False] * (n // 2))
    mobs, _ = env.reset(options={"reset_mask": mask})
    keep = torch.from_numpy(~mask)
    for got, old in zip(_leaves(env.carry.state), _leaves(before)):
        assert torch.equal(got[keep], old[keep])
        assert not torch.equal(got[~keep], old[~keep])
    assert torch.equal(mobs[keep], obs[keep])
    assert not env.carry.state["count"][~keep].any()


class _Pair(NamedTuple):
    a: torch.Tensor
    b: list


def test_tree_map_keeps_structure():
    x = {"u": torch.ones(2), "v": (torch.zeros(1), _Pair(torch.ones(1), [torch.ones(3)]))}
    y = tf.tree_map(lambda p, q: p + q, x, x)
    assert isinstance(y["v"][1], _Pair) and isinstance(y["v"][1].b, list)
    assert torch.equal(y["v"][1].b[0], torch.full((3,), 2.0))
    leaf = torch.arange(3.0)
    assert tf.tree_map(lambda t: t * 2, leaf).tolist() == [0.0, 2.0, 4.0]
