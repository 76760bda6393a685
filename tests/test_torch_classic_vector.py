"""This slice's envs under ``TorchVectorEnv`` against ``JaxVectorEnv``, across autoresets.

Eight envs take eight steps with a time limit of 3. Threefry and torch
generators draw different numbers, so:

- resets: both sides reset to the same states, the port's ``reset_values``
  of numpy draws (the pattern of ``tests/test_torch_mujoco_robots_vector.py``;
  CPD's reset draws nothing);
- transitions that draw (slippery FrozenLake and CliffWalking, rainy Taxi,
  Blackjack, CPD's random opponents): JAX steps with its own keys, and the
  port is fed the draws those keys give, recomputed before each step from
  the carry's key (``split(rng, 6)[2]``, then one key a lane).

The JAX hooks are jitted on the instance and the vector env runs eagerly.
Observations, rewards, flags, step counters and states must agree: equal
for the tabular envs and Blackjack, within ``1e-5 * max |JAX| + 1e-6`` for
Pendulum, both MountainCars and CPD, ``1e-4`` for Acrobot.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.blockchain.cpd_functional import BlockchainCPDFunctional as JaxCPD
from gymnasium_tpu.envs.phys2d.acrobot import AcrobotFunctional as JaxAcrobot
from gymnasium_tpu.envs.phys2d.mountain_car import ContinuousMountainCarFunctional as JaxContinuousMountainCar
from gymnasium_tpu.envs.phys2d.mountain_car import MountainCarFunctional as JaxMountainCar
from gymnasium_tpu.envs.phys2d.pendulum import PendulumFunctional as JaxPendulum
from gymnasium_tpu.envs.tabular.blackjack import BlackjackFunctional as JaxBlackjack
from gymnasium_tpu.envs.tabular.cliffwalking import CliffWalkingFunctional as JaxCliffWalking
from gymnasium_tpu.envs.tabular.frozen_lake import FrozenLake8x8Functional as JaxFrozenLake8x8
from gymnasium_tpu.envs.tabular.taxi import TaxiFunctional as JaxTaxi
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from gymnasium_tpu_torch.envs.blockchain import BlockchainCPDFunctional
from gymnasium_tpu_torch.envs.phys2d import (
    AcrobotFunctional,
    ContinuousMountainCarFunctional,
    MountainCarFunctional,
    PendulumFunctional,
)
from gymnasium_tpu_torch.envs.tabular import (
    BlackjackFunctional,
    CliffWalkingFunctional,
    FrozenLake8x8Functional,
    TaxiFunctional,
)
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.test_torch_blackjack import jax_step_cards
from tests.test_torch_cpd import jax_dirichlet
from tests.test_torch_tabular import jax_gumbels

N, STEPS, TIME_LIMIT = 8, 8, 3
# name: (port class, JAX class, options, relative tolerance or None for equality)
CASES = {
    "frozen_lake_8x8": (FrozenLake8x8Functional, JaxFrozenLake8x8, {}, None),
    "taxi": (TaxiFunctional, JaxTaxi, {}, None),
    "taxi_rainy": (TaxiFunctional, JaxTaxi, {"is_rainy": True}, None),
    "cliffwalking_slippery": (CliffWalkingFunctional, JaxCliffWalking, {"is_slippery": True}, None),
    "blackjack": (BlackjackFunctional, JaxBlackjack, {"natural": True}, None),
    "pendulum": (PendulumFunctional, JaxPendulum, {}, 1e-5),
    "mountain_car": (MountainCarFunctional, JaxMountainCar, {}, 1e-5),
    "continuous_mountain_car": (ContinuousMountainCarFunctional, JaxContinuousMountainCar, {}, 1e-5),
    "acrobot": (AcrobotFunctional, JaxAcrobot, {}, 1e-4),
    "cpd_random": (BlockchainCPDFunctional, JaxCPD, {"opponent_policy": "random", "num_miners": 3, "max_rounds": 2},
                   1e-5),
}


def reset_draws(name, env, rng):
    """One batch of the port's reset draws for ``env``, or None where the reset draws nothing."""
    if hasattr(env, "model"):
        return (torch.from_numpy(rng.gumbel(size=(N, env.model.num_states)).astype(np.float32)),)
    if name == "blackjack":
        return (torch.from_numpy(rng.integers(0, 13, (N, 4))),)
    if name == "cpd_random":
        return None
    shape = {"pendulum": (N, 2), "acrobot": (N, 4)}.get(name, (N,))
    return (torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)),)


def step_draws(name, env, keys):
    """The draws JAX's transition takes from the lane ``keys``, as the port's
    ``transition_draws`` returns them."""
    if hasattr(env, "model"):
        return (None if env._deterministic else torch.from_numpy(jax_gumbels(keys, env.model.probs.shape[-1])),)
    if name == "blackjack":
        return tuple(torch.from_numpy(np.array(x)) for x in jax_step_cards(keys))
    return (torch.from_numpy(jax_dirichlet(keys, env.num_miners)),)


def injected_pair(name):
    port_cls, jax_cls, options, _ = CASES[name]
    rng = np.random.default_rng(0)
    draws = [reset_draws(name, port_cls(dict(options)), rng) for _ in range(STEPS + 1)]
    states = None
    if draws[0] is not None:
        states = [{k: v.numpy() for k, v in _as_dict(port_cls(dict(options)).reset_values(*d)).items()} for d in draws]
    queue = collections.deque()

    class Port(port_cls):
        def __init__(self):
            super().__init__(dict(options))
            self.resets = iter(states or ())

        if states is not None:
            def initial_batched(self, rng, n, params=None):
                return _from_dict({k: torch.from_numpy(v) for k, v in next(self.resets).items()})

        if hasattr(port_cls, "transition_draws"):
            def transition_draws(self, rng, n):
                return queue.popleft()

    class Jax(jax_cls):
        def __init__(self):
            super().__init__(dict(options))
            self.resets = iter(states or ())
            for hook in ("transition", "observation", "reward", "terminal"):
                setattr(self, hook, jax.jit(getattr(super(), hook)))

        if states is not None:
            def initial_batched(self, rng, n, params=None):
                return _from_dict({k: jnp.asarray(v) for k, v in next(self.resets).items()})

    return Port(), Jax(), queue


def _as_dict(state):
    return state if isinstance(state, dict) else {"": state}


def _from_dict(tree):
    return tree[""] if list(tree) == [""] else tree


def _actions(env, rng):
    space = env.action_space
    if hasattr(space, "n"):
        return rng.integers(0, int(space.n), (STEPS, N)).astype(np.int32)
    return rng.uniform(-1.2, 1.2, (STEPS, N) + space.shape).astype(np.float32) * float(np.max(space.high))


def _agree(got, want, rel, label):
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, label
    if rel is None:
        np.testing.assert_array_equal(got, want, err_msg=label)
    else:
        atol = rel * float(np.abs(want).max(initial=0.0)) + 1e-6
        np.testing.assert_allclose(got, want, rtol=0.0, atol=atol, err_msg=label)


@pytest.mark.parametrize("name", sorted(CASES))
def test_vector_env_matches_jax_across_autoresets(name):
    rel = CASES[name][3]
    port, jax_env, queue = injected_pair(name)
    tenv = TorchVectorEnv(port, N, max_episode_steps=TIME_LIMIT, device="cpu")
    jenv = JaxVectorEnv(jax_env, num_envs=N, max_episode_steps=TIME_LIMIT, jit=False)
    tobs, _ = tenv.reset(seed=0)
    jobs, _ = jenv.reset(seed=0)
    _agree(tobs, jobs, rel, "reset obs")
    actions = _actions(port, np.random.default_rng(1))
    ends = resets = 0
    for s in range(STEPS):
        if hasattr(port, "transition_draws"):
            k_trans = jax.random.split(jenv.carry.rng, 6)[2]
            queue.append(step_draws(name, port, jax.random.split(k_trans, N)))
        resets += int(tenv.carry.prev_done.sum())
        jo, jr, jte, jtr, _ = jenv.step(jnp.asarray(actions[s]))
        to, tr, tte, ttr, _ = tenv.step(torch.from_numpy(actions[s]))
        _agree(to, jo, rel, f"step {s} obs")
        _agree(tr, jr, rel, f"step {s} reward")
        for label, got, want in (("terminated", tte, jte), ("truncated", ttr, jtr),
                                 ("steps", tenv.carry.steps, jenv.carry.steps),
                                 ("prev_done", tenv.carry.prev_done, jenv.carry.prev_done)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want), err_msg=f"step {s} {label}")
        tstate, jstate = _as_dict(tenv.carry.state), _as_dict(jenv.carry.state)
        for key in jstate:
            _agree(tstate[key], jstate[key], rel, f"step {s} state {key}")
        ends += int((tte | ttr).sum())
    assert not queue and ends > 0 and resets > 0
