"""The port's Pendulum, MountainCar, ContinuousMountainCar and Acrobot against
the JAX package's functionals, on the CPU.

- Every hook on edge states: the left wall, the goal, the speed and torque
  clips, wraps at ±π, angles several turns out. The JAX hooks are vmapped
  and jitted. States, observations and rewards agree within ``1e-5 * max
  |JAX| + 1e-6``; flags are equal (Acrobot's outside a ``1e-5`` band around
  its threshold ``-cos θ1 - cos(θ1 + θ2) = 1``). Acrobot at its speed
  bounds (4π and 9π rad/s) is held at ``1e-4``: there one RK4 step turns a
  link by up to 6 rad, and float32 rounding takes JAX's step 1.2e-3 and the
  port's 3e-4 away from the same step in float64.
- Trajectories of 8 steps from the same states and actions, each side
  stepping its own state: the same tolerance, Acrobot's at ``1e-4`` (its
  float32 RK4 drifts from JAX's in a few tens of steps), from JAX's reset
  states and, for Acrobot, from swinging states too.
- Resets: JAX's ``initial_batched`` on a key against the port's
  ``reset_values`` fed the uniforms that key draws, within ``1e-6``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.dynamics import acrobot as jax_acrobot_dyn
from gymnasium_tpu.envs.dynamics import pendulum as jax_pendulum_dyn
from gymnasium_tpu.envs.phys2d.acrobot import AcrobotFunctional as JaxAcrobot
from gymnasium_tpu.envs.phys2d.mountain_car import ContinuousMountainCarFunctional as JaxContinuousMountainCar
from gymnasium_tpu.envs.phys2d.mountain_car import MountainCarFunctional as JaxMountainCar
from gymnasium_tpu.envs.phys2d.pendulum import PendulumFunctional as JaxPendulum
from gymnasium_tpu_torch.envs.dynamics import acrobot as acrobot_dyn
from gymnasium_tpu_torch.envs.dynamics import pendulum as pendulum_dyn
from gymnasium_tpu_torch.envs.phys2d import (
    AcrobotFunctional,
    ContinuousMountainCarFunctional,
    MountainCarFunctional,
    PendulumFunctional,
)
from gymnasium_tpu_torch.spaces import Discrete

ENVS = {
    "pendulum": (PendulumFunctional, JaxPendulum),
    "mountain_car": (MountainCarFunctional, JaxMountainCar),
    "continuous_mountain_car": (ContinuousMountainCarFunctional, JaxContinuousMountainCar),
    "acrobot": (AcrobotFunctional, JaxAcrobot),
}
THRESHOLD_BAND = 1e-5
TRAJECTORY_TOL = {"pendulum": 1e-5, "mountain_car": 1e-5, "continuous_mountain_car": 1e-5, "acrobot": 1e-4}
PI = math.pi


def assert_close(got, want, label, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, label
    atol = rel * float(np.abs(want).max(initial=0.0)) + 1e-6
    np.testing.assert_allclose(got, want, rtol=0.0, atol=atol, err_msg=label)


def _grid(*axes):
    return np.stack([g.ravel() for g in np.meshgrid(*axes, indexing="ij")], axis=-1).astype(np.float32)


def edge_states(name):
    """``(states, actions)`` covering each env's edges, every action at each state."""
    if name == "pendulum":
        th = [0.0, PI, -PI, np.nextafter(np.float32(PI), 0), -3.5, 3 * PI, -7.25 * PI, 20.3, -13.1, 1e-7]
        states = _grid(np.array(th), np.array([0.0, 7.99, 8.0, -8.0, 12.0, -12.0, 0.5]))
        actions = np.array([-3.0, -2.0, -0.7, 0.0, 1.5, 2.0, 3.0], np.float32)[:, None]
    elif name in ("mountain_car", "continuous_mountain_car"):
        pos = [-1.2, -1.19, -0.9, -0.5, 0.0, 0.449, 0.45, 0.4999, 0.5, 0.55, 0.6]
        states = _grid(np.array(pos), np.array([-0.07, -0.069, -0.001, 0.0, 0.001, 0.069, 0.07]))
        actions = (np.arange(3, dtype=np.int32) if name == "mountain_car"
                   else np.array([-2.0, -1.0, -0.3, 0.0, 0.5, 1.0, 3.0], np.float32)[:, None])
    else:
        th = np.array([0.0, PI, -PI, 3 * PI, -5.5, 0.1, 2.9, -9.0])
        vel1, vel2 = np.array([0.0, 3.0, -1.0]), np.array([0.0, -2.0, 4.0])
        if name == "acrobot_speed_bounds":  # where the previous step's clip leaves them
            vel1, vel2 = np.array([4 * PI, -4 * PI, 2.0]), np.array([9 * PI, -9 * PI, -3.0])
        states = _grid(th, th, vel1, vel2)
        actions = np.arange(3, dtype=np.int32)
    n, k = states.shape[0], actions.shape[0]
    return np.repeat(states, k, axis=0), np.tile(actions, (n,) + (1,) * (actions.ndim - 1))


def jax_hooks(jenv):
    params = jenv.get_default_params()
    return {
        "transition": jax.jit(jax.vmap(lambda s, a: jenv.transition(s, a, None, params))),
        "observation": jax.jit(jax.vmap(lambda s: jenv.observation(s, None, params))),
        "reward": jax.jit(jax.vmap(lambda s, a, ns: jenv.reward(s, a, ns, None, params))),
        "terminal": jax.jit(jax.vmap(lambda s: jenv.terminal(s, None, params))),
    }


def acrobot_near_threshold(state):
    state = np.asarray(state, np.float64)
    height = -np.cos(state[:, 0]) - np.cos(state[:, 0] + state[:, 1])
    return np.abs(height - 1.0) < THRESHOLD_BAND


def compare_step(name, penv, hooks, state, action, rel):
    """One step of every hook from the same ``state`` on both sides."""
    gen = torch.Generator()
    pstate, paction = torch.from_numpy(state), torch.from_numpy(action)
    jstate, jaction = jnp.asarray(state), jnp.asarray(action)
    pnext = penv.transition(pstate, paction, gen)
    jnext = hooks["transition"](jstate, jaction)
    assert_close(pnext.numpy(), jnext, f"{name} transition", rel)
    assert_close(penv.observation(pnext, gen).numpy(), hooks["observation"](jnext), f"{name} observation", rel)
    assert_close(penv.reward(pstate, paction, pnext, gen).numpy(), hooks["reward"](jstate, jaction, jnext),
                 f"{name} reward", rel)
    term, jterm = penv.terminal(pnext, gen).numpy(), np.asarray(hooks["terminal"](jnext))
    assert term.dtype == jterm.dtype == np.bool_
    away = ~acrobot_near_threshold(jnext) if name == "acrobot" else np.ones(term.shape, bool)
    np.testing.assert_array_equal(term[away], jterm[away], err_msg=f"{name} terminal")
    return pnext.numpy(), np.asarray(jnext), term


@pytest.mark.parametrize("name", sorted(ENVS) + ["acrobot_speed_bounds"])
def test_hooks_on_edge_states_match_jax(name):
    env = "acrobot" if name.startswith("acrobot") else name
    port_cls, jax_cls = ENVS[env]
    penv, hooks = port_cls(), jax_hooks(jax_cls())
    state, action = edge_states(name)
    rel = 1e-4 if name == "acrobot_speed_bounds" else 1e-5
    pnext, _, term = compare_step(env, penv, hooks, state, action, rel)
    if name == "pendulum":  # the speed clip
        assert np.abs(pnext[:, 1]).max() == np.float32(8.0)
    elif env == "acrobot":  # the angles wrapped
        assert pnext[:, :2].min() >= -np.float32(PI) and pnext[:, :2].max() < np.float32(PI)
        if name == "acrobot_speed_bounds":  # and the speeds bounded
            assert np.abs(pnext[:, 2]).max() == np.float32(4 * PI)
            assert np.abs(pnext[:, 3]).max() == np.float32(9 * PI)
    else:  # the left wall stops the car, the goal ends the episode
        at_wall = pnext[:, 0] == np.float32(-1.2)
        assert at_wall.any() and (pnext[at_wall, 1] >= 0).all()
        assert term.any() and not term.all()


@pytest.mark.parametrize("name", sorted(ENVS) + ["acrobot_swinging"])
def test_trajectories_match_jax(name):
    env = "acrobot" if name.startswith("acrobot") else name
    port_cls, jax_cls = ENVS[env]
    penv, jenv = port_cls(), jax_cls()
    hooks = jax_hooks(jenv)
    n, rng = 512, np.random.default_rng(3)
    state = np.array(jenv.initial_batched(jax.random.PRNGKey(4), n))
    if name == "acrobot_swinging":  # anywhere, at up to 2 and 4 rad/s
        state = rng.uniform([-PI, -PI, -2, -4], [PI, PI, 2, 4], (n, 4)).astype(np.float32)
    pstate = jstate = state
    tol, terminations = TRAJECTORY_TOL[env], 0
    for step in range(8):
        if isinstance(penv.action_space, Discrete):
            action = rng.integers(0, int(penv.action_space.n), n).astype(np.int32)
        else:  # past the clip on either side
            action = rng.uniform(-1.5, 1.5, (n, 1)).astype(np.float32) * float(penv.action_space.high[0])
        pstate, _, term = compare_step(env, penv, hooks, pstate, action, tol)
        jstate = np.asarray(hooks["transition"](jnp.asarray(jstate), jnp.asarray(action)))
        assert_close(pstate, jstate, f"{name} state after step {step}", tol)
        terminations += int(term.sum())
    assert terminations > 0 or name != "acrobot_swinging"


@pytest.mark.parametrize("name", sorted(ENVS))
def test_reset_matches_jax_on_its_uniform_bits(name):
    port_cls, jax_cls = ENVS[name]
    penv, jenv = port_cls(), jax_cls()
    key, n = jax.random.PRNGKey(5), 4096
    want = np.asarray(jenv.initial_batched(key, n))
    shape = (n,) if "mountain_car" in name else want.shape
    u = torch.from_numpy(np.array(jax.random.uniform(key, shape)))
    got = penv.reset_values(u).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0.0, atol=1e-6)
    assert penv.observation_space.contains(penv.observation(torch.from_numpy(got[:1]), None).numpy()[0])


ANGLES = np.array([0.0, PI, -PI, np.float32(PI), -np.float32(PI), np.nextafter(np.float32(PI), 4),
                   np.nextafter(-np.float32(PI), -4), -0.5, -3.0, -PI / 2, 2 * PI, -2 * PI, 5 * PI, -5 * PI,
                   7.3 * PI, -9.9 * PI, 61.0, -61.0, 1e-8, -1e-8], np.float32)


def test_angle_wraps_are_the_floor_remainder_of_jax():
    x = torch.from_numpy(ANGLES)
    got = pendulum_dyn.angle_normalize(torch, x).numpy()
    want = np.asarray(jax_pendulum_dyn.angle_normalize(jnp, jnp.asarray(ANGLES)))
    np.testing.assert_array_equal(got, want)
    assert (got >= -np.float32(PI)).all() and (got < np.float32(PI)).all()
    got = acrobot_dyn.wrap(torch, x, -PI, PI).numpy()
    want = np.asarray(jax_acrobot_dyn.wrap(jnp, jnp.asarray(ANGLES), -PI, PI))
    np.testing.assert_array_equal(got, want)
    # torch.fmod truncates toward zero: negative angles would not wrap
    assert not np.array_equal(torch.fmod(x + PI, 2 * PI).numpy() - np.float32(PI), got)
