"""The port's classic-control host env classes against the JAX package's,
through ``make(id)`` and ``make_vec(id, vectorization_mode="vector_entry_point")``.

JAX's classes are plain numpy in float64 and call no JAX; the port's are the
same code over the port's ``Env``, ``VectorEnv``, spaces and canvas. Both run
the same numpy code on one machine, so every output is equal bit for bit:
the reset and 200 steps of one action stream (observations, rewards, flags,
``info``), the generators after every call, ``rgb_array`` frames, the reset
options, CartPole's ``sutton_barto_reward``, and ``CartPoleVectorEnv`` over
600 steps across its autoresets and its 500-step truncation.
"""

import math
import warnings

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.classic_control import CartPoleEnv as JaxCartPoleEnv
from gymnasium_tpu.envs.classic_control import pendulum as jpendulum
from gymnasium_tpu.envs.classic_control import utils as jutils
from gymnasium_tpu.envs.dynamics import acrobot as jacrobot
from gymnasium_tpu_torch.envs.classic_control import CartPoleEnv, CartPoleVectorEnv
from gymnasium_tpu_torch.envs.classic_control import pendulum
from gymnasium_tpu_torch.envs.classic_control import utils
from gymnasium_tpu_torch.envs.dynamics import acrobot
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.torch_compare import assert_host_env_matches_jax, assert_identical, assert_same_space

CLASSIC = {
    "CartPole-v0": "CartPoleEnv",
    "CartPole-v1": "CartPoleEnv",
    "MountainCar-v0": "MountainCarEnv",
    "MountainCarContinuous-v0": "Continuous_MountainCarEnv",
    "Pendulum-v1": "PendulumEnv",
    "Acrobot-v1": "AcrobotEnv",
}
STEPS = 200
RESET_OPTIONS = {
    "CartPole-v1": {"low": -0.2, "high": 0.15},
    "MountainCar-v0": {"low": -0.55, "high": -0.45},
    "MountainCarContinuous-v0": {"low": -1.1, "high": 0.3},
    "Acrobot-v1": {"low": -0.3, "high": 0.25},
    "Pendulum-v1": {"x_init": 1.5, "y_init": 0.25},
}
VECTOR_ENVS = 8
VECTOR_STEPS = 600


@pytest.mark.parametrize("env_id", sorted(CLASSIC))
def test_make_matches_jax_bit_for_bit(env_id):
    port, ref = gym.make(env_id, render_mode="rgb_array"), jgym.make(env_id, render_mode="rgb_array")
    assert type(port.unwrapped).__name__ == CLASSIC[env_id]
    assert type(port.unwrapped).__module__.startswith("gymnasium_tpu_torch.envs.classic_control.")
    assert_host_env_matches_jax(port, ref, STEPS, seed=3, render_every=40)
    port.close()
    ref.close()


@pytest.mark.parametrize("env_id", sorted(RESET_OPTIONS))
def test_reset_options_match_jax(env_id):
    port, ref = gym.make(env_id), jgym.make(env_id)
    assert_host_env_matches_jax(port, ref, 50, seed=5, options=RESET_OPTIONS[env_id])


@pytest.mark.parametrize("options", [{"low": "a"}, {"low": 0.2, "high": -0.2}, {"x_init": None}],
                         ids=["not_a_number", "low_above_high", "x_init_none"])
def test_bad_reset_options_raise_as_jax_does(options):
    env_id = "Pendulum-v1" if "x_init" in options else "CartPole-v1"
    with pytest.raises(ValueError) as got:
        gym.make(env_id).reset(seed=0, options=options)
    with pytest.raises(ValueError) as want:
        jgym.make(env_id).reset(seed=0, options=options)
    assert str(got.value) == str(want.value)


def test_cartpole_sutton_barto_reward_matches_jax():
    port = gym.make("CartPole-v1", sutton_barto_reward=True)
    ref = jgym.make("CartPole-v1", sutton_barto_reward=True)
    assert assert_host_env_matches_jax(port, ref, STEPS, seed=2) > 0


def _steps_after_terminated(env_class):
    """Step ``env_class()`` past its termination: the rewards and warnings of
    the two steps after it."""
    env = env_class()
    env.reset(seed=0)
    terminated = False
    while not terminated:
        _, _, terminated, _, _ = env.step(1)
    out = []
    for _ in range(2):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            _, reward, terminated, _, _ = env.step(1)
        out.append((reward, terminated, [str(w.message) for w in caught]))
    return out


def test_cartpole_warns_once_when_stepped_after_terminated():
    got, want = _steps_after_terminated(CartPoleEnv), _steps_after_terminated(JaxCartPoleEnv)
    assert got == want
    (reward, terminated, messages), (_, _, again) = got
    assert reward == 0.0 and terminated and again == []
    assert len(messages) == 1 and "already returned terminated = True" in messages[0]


def _balancing(obs, rng):
    """Actions for a batch: the first five lanes balance the pole (they reach
    the 500-step truncation), the other three act at random (their episodes
    end early and autoreset)."""
    control = (10 * obs[:, 2] + 2 * obs[:, 3] + 0.3 * obs[:, 0] + 0.6 * obs[:, 1] > 0).astype(np.int64)
    return np.where(np.arange(len(obs)) < 5, control, rng.integers(0, 2, len(obs)))


def test_cartpole_vector_env_matches_jax_over_600_steps():
    port = gym.make_vec("CartPole-v1", VECTOR_ENVS, vectorization_mode="vector_entry_point")
    ref = jgym.make_vec("CartPole-v1", VECTOR_ENVS, vectorization_mode="vector_entry_point")
    assert isinstance(port, CartPoleVectorEnv) and type(ref).__name__ == "CartPoleVectorEnv"
    assert port.max_episode_steps == ref.max_episode_steps == 500
    assert port.metadata == {**ref.metadata, "autoreset_mode": port.metadata["autoreset_mode"]}
    assert port.metadata["autoreset_mode"].value == ref.metadata["autoreset_mode"].value
    for got, want in ((port.single_action_space, ref.single_action_space),
                      (port.action_space, ref.action_space),
                      (port.single_observation_space, ref.single_observation_space),
                      (port.observation_space, ref.observation_space)):
        assert_same_space(got, want)
    obs, info = port.reset(seed=0)
    assert_identical((obs, info), ref.reset(seed=0))
    rng = np.random.default_rng(7)
    truncations = terminations = autoresets = 0
    for k in range(VECTOR_STEPS):
        action = _balancing(obs, rng)
        was_done = port.prev_done.copy()
        out = port.step(action)
        assert_identical(out, ref.step(action), f"step {k}")
        assert port.np_random.bit_generator.state == ref.np_random.bit_generator.state
        obs = out[0]
        truncations += int(out[3].sum())
        terminations += int(out[2].sum())
        autoresets += int(was_done.sum())
    assert truncations >= 5 and terminations > 0 and autoresets == truncations + terminations - int(port.prev_done.sum())
    assert_identical(port.steps, ref.steps)


@pytest.mark.parametrize("render_mode", ["rgb_array", "rgb_array_list"])
def test_cartpole_vector_env_render_matches_jax(render_mode):
    port = gym.make_vec("CartPole-v1", 3, vectorization_mode="vector_entry_point", render_mode=render_mode)
    ref = jgym.make_vec("CartPole-v1", 3, vectorization_mode="vector_entry_point", render_mode=render_mode)
    port.reset(seed=1)
    ref.reset(seed=1)
    for _ in range(3):
        port.step(np.ones(3, np.int64))
        ref.step(np.ones(3, np.int64))
    frames = port.render()
    assert_identical(frames, ref.render())
    assert len(frames) == 3
    first = frames[0][0] if render_mode.endswith("_list") else frames[0]
    assert first.shape == (400, 600, 3) and first.dtype == np.uint8


@pytest.mark.parametrize("env_id", sorted(CLASSIC))
def test_make_vec_with_no_mode_still_takes_the_torch_mode(env_id):
    env = gym.make_vec(env_id, 2, vector_kwargs={"device": "cpu"})
    assert isinstance(env, TorchVectorEnv) and env.spec.kwargs["vectorization_mode"] == "torch"


def test_acrobot_wrap_exact_matches_jax_beyond_three_pi():
    xs = np.concatenate([np.linspace(-25.0, 25.0, 2001), 3 * math.pi * np.array([-1, 1]),
                         np.nextafter(3 * math.pi, 0) * np.array([-1, 1]), [math.pi, -math.pi, 0.0, -0.0]])
    for x in xs:
        got = acrobot.wrap_exact(np.float64(x), -math.pi, math.pi)
        want = jacrobot.wrap_exact(np.float64(x), -math.pi, math.pi)
        assert_identical(got, want, f"wrap_exact({x!r})")
        assert -math.pi <= got <= math.pi
    # the host step with the scalar wrap, from states whose angles leave [-pi, pi)
    rng = np.random.default_rng(0)
    params = acrobot.AcrobotParams()
    for _ in range(200):
        state = np.concatenate([rng.uniform(-3 * math.pi, 3 * math.pi, 2), rng.uniform(-30, 30, 2)])
        torque = float(rng.choice([-1.0, 0.0, 1.0]))
        got = acrobot.integrate(np, state, torque, params, wrap_fn=acrobot.wrap_exact)
        want = jacrobot.integrate(np, state, torque, jacrobot.AcrobotParams(), wrap_fn=jacrobot.wrap_exact)
        assert_identical(got, want)


def test_acrobot_torch_path_keeps_the_floor_remainder_wrap():
    state = torch.tensor([[3.0, -3.1, 12.0, -25.0], [0.1, 0.2, 0.3, 0.4]], dtype=torch.float64)
    params = acrobot.AcrobotParams()
    got = acrobot.integrate(torch, state, 1.0, params)
    again = acrobot.integrate(torch, state, 1.0, params, wrap_fn=lambda x, lo, hi: acrobot.wrap(torch, x, lo, hi))
    assert torch.equal(got, again)
    want = jacrobot.integrate(np, state.numpy(), 1.0, jacrobot.AcrobotParams())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_reset_bound_helpers_match_jax():
    for options in (None, {}, {"low": -1}, {"high": "0.5"}, {"low": -0.3, "high": 0.3}):
        assert_identical(utils.maybe_parse_reset_bounds(options, -0.05, 0.05),
                         jutils.maybe_parse_reset_bounds(options, -0.05, 0.05))
    for bad in ("x", None, [1, 2]):
        with pytest.raises(ValueError) as got:
            utils.verify_number_and_cast(bad)
        with pytest.raises(ValueError) as want:
            jutils.verify_number_and_cast(bad)
        assert str(got.value) == str(want.value)


def test_pendulum_angle_normalize_matches_jax():
    xs = np.linspace(-20, 20, 1001)
    assert_identical(pendulum.angle_normalize(xs), jpendulum.angle_normalize(xs))
