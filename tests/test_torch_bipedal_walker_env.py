"""The port's host ``BipedalWalker`` class against the JAX package's, through
``make``: ``gymnasium_tpu_torch.make(id, device="cpu")`` against
``gymnasium_tpu.make(id)`` for the normal and hardcore forms.

JAX's class steps its walker with numpy in float64; the port's runs the
terrain kernel's and the walker build's float32 twins on the CPU (the
kernels on the card). Both draw the reset from ``np_random`` in the same
calls and order. Tolerances are per element, ``atol + rtol * |JAX|``:

- the reset observation within 1e-5 + 1e-5 |JAX| (largest seen 4.9e-6);
- the heightfield within 1e-5 (7.6e-7 seen);
- 3 teacher-forced steps, each from JAX's state cast to float32: the
  observation within 1e-5 + 1e-5 |JAX| (3.5e-6 seen), the reward within
  1e-4 + 1e-5 |JAX| (6.1e-6 seen), the legs' contact entries (8 and 13,
  from the solver's flags as in JAX's host class) and ``terminated`` equal;
- an ``rgb_array`` frame equal except on at most 0.5 % of pixels.

The JAX host reset keeps the settle tick's ``done``; so does the port's.
A walker twin step takes about 0.3 s on the CPU, so the steps are few.
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.envs.box2d import bipedal_walker as jbw
from gymnasium_tpu.physics import planar as jplanar
from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as bw
from gymnasium_tpu_torch.physics import planar

IDS = ("BipedalWalker-v3", "BipedalWalkerHardcore-v3")
STEPS = 3
OBS_TOL = (1e-5, 1e-5)
REWARD_TOL = (1e-4, 1e-5)
TERRAIN_TOL = 1e-5
LEGS = [8, 13]
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


def same_generators(port, jax_env) -> bool:
    return port.unwrapped.np_random.bit_generator.state == jax_env.unwrapped.np_random.bit_generator.state


@pytest.mark.parametrize("env_id", IDS)
def test_reset_and_teacher_forced_steps_match_jax(env_id):
    port, jax_env = gym.make(env_id, device="cpu"), jgym.make(env_id)
    got, info = port.reset(seed=4)
    want, want_info = jax_env.reset(seed=4)
    assert got.dtype == np.float32 and got.shape == (24,) and info == want_info
    within(got, want, OBS_TOL, "reset obs")
    assert same_generators(port, jax_env)
    state, jstate = port.unwrapped.state, jax_env.unwrapped.state
    assert list(state) == list(jstate)
    for key, value in jstate.items():
        assert tuple(state[key].shape) == np.shape(value), key
    np.testing.assert_allclose(state["terrain"].numpy(), jstate["terrain"], rtol=0, atol=TERRAIN_TOL)
    assert bool(state["done"]) == bool(jstate["done"]) and float(state["r"]) == float(jstate["r"]) == 0.0
    rng = np.random.default_rng(4)
    for i in range(STEPS):
        action = rng.uniform(-1, 1, 4).astype(np.float32)
        port.unwrapped.state = to_port(jax_env.unwrapped.state)
        got, want = port.step(action), jax_env.step(action)
        assert got[0].dtype == np.float32 and isinstance(got[1], float) and isinstance(got[2], bool)
        within(got[0], want[0], OBS_TOL, f"step {i} obs")
        within(got[1], want[1], REWARD_TOL, f"step {i} reward")
        assert np.array_equal(got[0][LEGS], want[0][LEGS]), f"step {i} legs"
        assert got[2:] == want[2:], f"step {i}"
        assert same_generators(port, jax_env)


def test_hardcore_terrain_has_obstacles_as_jax():
    port, jax_env = gym.make(IDS[1], device="cpu"), jgym.make(IDS[1])
    port.reset(seed=9)
    jax_env.reset(seed=9)
    got, want = port.unwrapped.state["terrain"].numpy(), jax_env.unwrapped.state["terrain"]
    np.testing.assert_allclose(got, want, rtol=0, atol=TERRAIN_TOL)
    normal = gym.make(IDS[0], device="cpu")
    normal.reset(seed=9)
    assert not np.allclose(normal.unwrapped.state["terrain"].numpy(), got, atol=0.1)


def test_legs_come_from_the_solver_flags():
    """The walker lifted 2 cm from its settled pose: after a step the
    solver's probes are clear of the ground, while the foot-height test
    (within 1 cm of the ground, at the shank's unrotated end) still says
    contact. The step's observation takes the solver's flags, as JAX's."""
    port, jax_env = gym.make(IDS[0], device="cpu"), jgym.make(IDS[0])
    port.reset(seed=0)
    jax_env.reset(seed=0)
    jax_env.unwrapped.state["bodies"][:, 1] += 0.02
    port.unwrapped.state = to_port(jax_env.unwrapped.state)
    action = np.zeros(4, np.float32)
    got, want = port.step(action), jax_env.step(action)
    assert np.array_equal(got[0][LEGS], want[0][LEGS]) and not got[0][LEGS].any()
    foot = port.unwrapped._observe()
    assert foot[LEGS].all()
    np.testing.assert_array_equal(foot[LEGS], jbw.observe_state(np, jax_env.unwrapped.state)[LEGS])


def test_reset_keeps_the_settle_ticks_done(monkeypatch):
    """The settle tick's termination stays set after the reset, in both
    packages; only its reward is cleared."""
    jax_step = jbw.walker_step
    port_tick = bw.walker_tick

    def jax_done(xp, state, action, *args):
        state, obs = jax_step(xp, state, action, *args)
        return {**state, "done": np.asarray(True), "r": np.asarray(5.0)}, obs

    def port_done(state, action):
        state, flags = port_tick(state, action)
        return {**state, "done": torch.ones_like(state["done"]), "r": state["r"] + 5.0}, flags

    monkeypatch.setattr(jbw, "walker_step", jax_done)
    monkeypatch.setattr(bw, "walker_tick", port_done)
    port, jax_env = gym.make(IDS[0], device="cpu"), jgym.make(IDS[0])
    port.reset(seed=1)
    jax_env.reset(seed=1)
    assert bool(jax_env.unwrapped.state["done"]) and float(jax_env.unwrapped.state["r"]) == 0.0
    assert bool(port.unwrapped.state["done"]) and float(port.unwrapped.state["r"]) == 0.0


def test_frame_matches_jax():
    port = gym.make(IDS[0], device="cpu", render_mode="rgb_array")
    jax_env = jgym.make(IDS[0], render_mode="rgb_array")
    port.reset(seed=2)
    jax_env.reset(seed=2)
    jax_env.step(np.full(4, 0.5, np.float32))
    port.unwrapped.state = to_port(jax_env.unwrapped.state)
    got, want = port.render(), jax_env.render()
    assert got.shape == want.shape == (400, 600, 3) and got.dtype == want.dtype == np.uint8
    share = float(np.any(got != want, axis=-1).mean())
    assert share <= FRAME_SHARE, share
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 2


def test_joint_angles_match_jax_on_walker_rows():
    rows = np.random.default_rng(6).normal(size=(64, 5, 6)).astype(np.float32)
    got = planar.joint_angles(torch.from_numpy(rows), bw._WORLD)
    want = jplanar.joint_angles(np, rows, jbw._WORLD)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == (64, 4)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-6, atol=1e-6)
    # the observation's joint entries are these angles and speeds
    state = {"bodies": torch.from_numpy(rows), "terrain": torch.zeros(64, 200)}
    obs = bw.observe_state(state)
    np.testing.assert_allclose(obs[:, [4, 6, 9, 11]].numpy() - [0, 1, 0, 1], got[0].numpy(), atol=1e-6)


def test_hardcore_guard_raises_jax_message():
    with pytest.raises(error.Error) as got:
        bw.BipedalWalkerHardcore()
    with pytest.raises(jgym.error.Error) as want:
        jbw.BipedalWalkerHardcore()
    assert str(got.value) == str(want.value)
