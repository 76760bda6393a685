"""The port's host ``LunarLander`` class against the JAX package's, through
``make``: ``gymnasium_tpu_torch.make(id, device="cpu")`` against
``gymnasium_tpu.make(id)`` for the discrete, continuous and windy forms.

JAX's class steps its dynamics with numpy in float64; the port's runs the
planar step's float32 twin on the CPU (the kernel on the card). Both draw
from ``np_random`` in the same calls and order, so the generators are
compared after the reset and after every step. Tolerances are per element,
``atol + rtol * |JAX|``:

- the reset observation within 1e-6 + 1e-6 |JAX| (largest seen 1.2e-7);
- 8 teacher-forced steps, each from JAX's state cast to float32: the
  observation within 1e-6 + 1e-6 |JAX| (3.0e-7 seen), the reward within
  1e-4 + 1e-5 |JAX| (5.2e-5 seen: the shaping potential is of order 100
  and the reward a difference of two), ``terminated`` equal;
- a free run of 8 steps on the same seed and actions within 1e-4 + 1e-4 |JAX|;
- an ``rgb_array`` frame equal except on at most 0.5 % of pixels (polygon
  edges that a float32 vertex moves across a pixel centre).

``heuristic`` gives JAX's action on 256 observations drawn from a seed, and
``joint_angles`` equals JAX's on random rows of the lander world.
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.box2d import lunar_lander as jll
from gymnasium_tpu.physics import planar as jplanar
from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.envs.box2d import lunar_lander as ll
from gymnasium_tpu_torch.envs.dynamics import lunar_lander as dyn
from gymnasium_tpu_torch.physics import planar

FORMS = {
    "discrete": ("LunarLander-v3", {}),
    "continuous": ("LunarLanderContinuous-v3", {}),
    "wind": ("LunarLander-v3", {"enable_wind": True}),
}
STEPS = 8
OBS_TOL = (1e-6, 1e-6)
REWARD_TOL = (1e-4, 1e-5)
FREE_TOL = (1e-4, 1e-4)
FRAME_SHARE = 0.005


def within(got, want, tol, label):
    atol, rtol = tol
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert (err <= atol + rtol * np.abs(want)).all(), f"{label}: {err.max()} at {np.argmax(err)}"


def to_port(state) -> dict:
    """JAX's host state as the port's: float32 and bool tensors on the CPU."""
    out = {}
    for key, value in state.items():
        value = np.asarray(value)
        out[key] = torch.from_numpy(value.copy() if value.dtype == bool else value.astype(np.float32))
    return out


def actions(env, n: int, seed: int):
    rng = np.random.default_rng(seed)
    if env.unwrapped.continuous:
        return list(rng.uniform(-1, 1, (n, 2)).astype(np.float32))
    return [int(a) for a in rng.integers(0, 4, n)]


def same_generators(port, jax_env) -> bool:
    return port.unwrapped.np_random.bit_generator.state == jax_env.unwrapped.np_random.bit_generator.state


def both(form: str):
    env_id, kwargs = FORMS[form]
    return gym.make(env_id, device="cpu", **kwargs), jgym.make(env_id, **kwargs)


@pytest.mark.parametrize("form", sorted(FORMS))
@pytest.mark.parametrize("seed", [0, 3])
def test_reset_matches_jax(form, seed):
    port, jax_env = both(form)
    got, info = port.reset(seed=seed)
    want, want_info = jax_env.reset(seed=seed)
    assert got.dtype == np.float32 and got.shape == want.shape and info == want_info
    within(got, want, OBS_TOL, "reset obs")
    assert same_generators(port, jax_env)
    state = port.unwrapped.state
    for key, value in jax_env.unwrapped.state.items():
        assert tuple(state[key].shape) == np.shape(value), key
        assert state[key].dtype == (torch.bool if np.asarray(value).dtype == bool else torch.float32), key
    assert (port.unwrapped.wind_idx, port.unwrapped.torque_idx) == (jax_env.unwrapped.wind_idx,
                                                                    jax_env.unwrapped.torque_idx)


@pytest.mark.parametrize("form", sorted(FORMS))
def test_teacher_forced_steps_match_jax(form):
    port, jax_env = both(form)
    port.reset(seed=5)
    jax_env.reset(seed=5)
    for i, action in enumerate(actions(port, STEPS, seed=5)):
        port.unwrapped.state = to_port(jax_env.unwrapped.state)
        got, want = port.step(action), jax_env.step(action)
        assert isinstance(got[1], float) and isinstance(got[2], bool) and got[0].dtype == np.float32
        within(got[0], want[0], OBS_TOL, f"step {i} obs")
        within(got[1], want[1], REWARD_TOL, f"step {i} reward")
        assert got[2:] == want[2:], f"step {i}"
        assert same_generators(port, jax_env), f"step {i}"
        assert port.unwrapped.wind_idx == jax_env.unwrapped.wind_idx


@pytest.mark.parametrize("form", sorted(FORMS))
def test_free_run_matches_jax(form):
    port, jax_env = both(form)
    within(port.reset(seed=7)[0], jax_env.reset(seed=7)[0], OBS_TOL, "reset obs")
    for i, action in enumerate(actions(port, STEPS, seed=7)):
        got, want = port.step(action), jax_env.step(action)
        within(got[0], want[0], FREE_TOL, f"step {i} obs")
        within(got[1], want[1], FREE_TOL, f"step {i} reward")
        assert got[2:] == want[2:]
        assert same_generators(port, jax_env)


def test_wind_walks_the_indices_on_the_host():
    port, jax_env = both("wind")
    port.reset(seed=1)
    jax_env.reset(seed=1)
    start = port.unwrapped.wind_idx
    port.step(0)
    jax_env.step(0)
    assert port.unwrapped.wind_idx == start + 1 == jax_env.unwrapped.wind_idx
    calm, _ = both("discrete")
    calm.reset(seed=1)
    start = calm.unwrapped.wind_idx
    calm.step(0)
    assert calm.unwrapped.wind_idx == start


@pytest.mark.parametrize("form", ["discrete", "continuous"])
def test_frame_matches_jax(form):
    env_id, kwargs = FORMS[form]
    port = gym.make(env_id, device="cpu", render_mode="rgb_array", **kwargs)
    jax_env = jgym.make(env_id, render_mode="rgb_array", **kwargs)
    port.reset(seed=2)
    jax_env.reset(seed=2)
    for action in actions(port, 3, seed=2):
        jax_env.step(action)
    port.unwrapped.state = to_port(jax_env.unwrapped.state)
    got, want = port.render(), jax_env.render()
    assert got.shape == want.shape == (400, 600, 3) and got.dtype == want.dtype == np.uint8
    share = float(np.any(got != want, axis=-1).mean())
    assert share <= FRAME_SHARE, share
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2


@pytest.mark.parametrize("continuous", [False, True])
def test_heuristic_gives_jax_actions(continuous):
    env_id = "LunarLanderContinuous-v3" if continuous else "LunarLander-v3"
    port, jax_env = gym.make(env_id, device="cpu"), jgym.make(env_id)
    rng = np.random.default_rng(11)
    obs = rng.uniform(-1.5, 1.5, (256, 8)).astype(np.float32)
    obs[:, 6:] = rng.integers(0, 2, (256, 2))
    for s in obs:
        got, want = ll.heuristic(port, s), jll.heuristic(jax_env, s)
        if continuous:
            assert got.dtype == want.dtype and np.array_equal(got, want)
        else:
            assert type(got) is type(want) and got == want


def test_joint_angles_match_jax_on_lander_rows():
    world = dyn._lander_world(-10.0)
    rows = np.random.default_rng(4).normal(size=(64, 3, 6)).astype(np.float32)
    got = planar.joint_angles(torch.from_numpy(rows), world)
    want = jplanar.joint_angles(np, rows, world)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (64, 2)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)


def test_continuous_guard_raises_jax_message():
    with pytest.raises(error.Error) as got:
        ll.LunarLanderContinuous()
    with pytest.raises(jgym.error.Error) as want:
        jll.LunarLanderContinuous()
    assert str(got.value) == str(want.value)


def test_no_device_means_the_card():
    if torch.cuda.is_available():
        assert gym.make("LunarLander-v3").unwrapped.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            gym.make("LunarLander-v3")
