"""The port's ``SyncVectorEnv`` against the JAX package's, both built by
``make_vec(id, n, vectorization_mode="sync")`` from the same seed and fed
the same actions.

The numpy host classes (CartPole, Pendulum, FrozenLake, Blackjack) give
equal batches in every bit (``assert_identical``: dtypes, bytes, infos and
their masks, ``final_obs``) over 210 steps across autoresets, in each
autoreset mode, through a masked partial reset and with
``observation_mode="different"``; ``call``/``get_attr``/``set_attr`` and
``render`` answer alike. HalfCheetah and LunarLander with ``device="cpu"``
step their float32 twins, so each sub-env is teacher-forced from JAX's
state before each step and held to the host-class tests' tolerances: the
HalfCheetah observation, reward and info values within ``1e-5 * max |JAX| +
1e-6``; LunarLander's observation within ``1e-6 + 1e-6 |JAX|`` and reward
within ``1e-4 + 1e-5 |JAX|``, per element.
"""

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.vector import AutoresetMode as JMode
from gymnasium_tpu_torch.vector import AutoresetMode, SyncVectorEnv
from tests.torch_compare import assert_identical, assert_same_space

N = 4
STEPS = 210
HOST_IDS = ("CartPole-v1", "Pendulum-v1", "FrozenLake-v1", "Blackjack-v1")


def both(env_id, n=N, **kwargs):
    jkwargs = {k: v for k, v in kwargs.items() if k != "device"}
    port = gym.make_vec(env_id, n, vectorization_mode="sync", **kwargs)
    ref = jgym.make_vec(env_id, n, vectorization_mode="sync", **jkwargs)
    assert isinstance(port, SyncVectorEnv) and type(ref).__name__ == "SyncVectorEnv"
    assert_same_space(port.single_observation_space, ref.single_observation_space)
    assert_same_space(port.single_action_space, ref.single_action_space)
    return port, ref


def run_alike(port, ref, steps, seed=0, action_seed=1, on_done=None) -> int:
    """Reset both with ``seed`` and step both with ``ref``'s seeded action
    samples; every output is identical. Returns the sub-episodes ended."""
    assert_identical(port.reset(seed=seed), ref.reset(seed=seed), "reset")
    ref.action_space.seed(action_seed)
    ended = 0
    for k in range(steps):
        actions = ref.action_space.sample()
        want = ref.step(actions)
        assert_identical(port.step(actions), want, f"step {k}")
        done = want[2] | want[3]
        ended += int(done.sum())
        if on_done is not None and done.any():
            on_done(done, k)
    return ended


@pytest.mark.parametrize("env_id", HOST_IDS)
def test_host_class_batches_equal_jax(env_id):
    port, ref = both(env_id)
    assert run_alike(port, ref, STEPS) > 0
    assert port.np_random_seed == ref.np_random_seed
    port.close()
    ref.close()


@pytest.mark.parametrize("mode", ["NextStep", "SameStep", "Disabled"])
def test_autoreset_mode_equals_jax(mode):
    port = gym.make_vec("CartPole-v1", N, vectorization_mode="sync", vector_kwargs={"autoreset_mode": mode})
    ref = jgym.make_vec("CartPole-v1", N, vectorization_mode="sync", vector_kwargs={"autoreset_mode": JMode(mode)})
    assert port.metadata["autoreset_mode"] is AutoresetMode(mode)

    def reset_done(done, k):
        if mode == "Disabled":
            want = ref.reset(options={"reset_mask": done.copy()})
            assert_identical(port.reset(options={"reset_mask": done.copy()}), want, f"masked reset after {k}")

    assert run_alike(port, ref, STEPS, on_done=reset_done) > 0
    port.close()
    ref.close()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_vector_env_leaves_the_class_metadata_alone(mode):
    """A vector env writes its autoreset mode into its own copy of the first
    sub-env's metadata, never into the env class's dict, so a later
    ``make`` of that id reports the mode its class declares."""
    from gymnasium_tpu_torch.envs.classic_control.cartpole import CartPoleEnv

    declared = {"render_modes": ["human", "rgb_array"], "render_fps": 50, "autoreset_mode": AutoresetMode.NEXT_STEP}
    assert CartPoleEnv.metadata == declared
    env = gym.make_vec("CartPole-v1", 2, vectorization_mode=mode, vector_kwargs={"autoreset_mode": "Disabled"})
    assert env.metadata["autoreset_mode"] is AutoresetMode.DISABLED
    env.close()
    assert CartPoleEnv.metadata == declared
    assert gym.make("CartPole-v1").metadata == declared


def test_disabled_mode_refuses_a_step_after_a_done():
    env = gym.make_vec("CartPole-v1", 2, vectorization_mode="sync", vector_kwargs={"autoreset_mode": "Disabled"})
    env.reset(seed=0)
    for _ in range(100):
        _, _, term, trunc, _ = env.step(np.array([0, 0]))
        if (term | trunc).any():
            break
    with pytest.raises(AssertionError, match="DISABLED"):
        env.step(np.array([0, 0]))
    env.close()


def test_masked_partial_reset_equals_jax():
    port, ref = both("CartPole-v1")
    run_alike(port, ref, 5)
    mask = np.array([True, False, True, False])
    assert_identical(port.reset(seed=[7, None, 9, None], options={"reset_mask": mask.copy()}),
                     ref.reset(seed=[7, None, 9, None], options={"reset_mask": mask.copy()}))
    actions = np.array([1, 0, 1, 1])
    assert_identical(port.step(actions), ref.step(actions))
    for bad in (np.array([1, 0, 1, 0]), np.array([False] * 4), np.array([True, False])):
        with pytest.raises(AssertionError):
            port.reset(options={"reset_mask": bad})
    port.close()
    ref.close()


def test_call_get_attr_set_attr_equal_jax():
    port, ref = both("CartPole-v1", n=3)
    port.reset(seed=0)
    ref.reset(seed=0)
    assert port.get_attr("gravity") == ref.get_attr("gravity") == (9.8, 9.8, 9.8)
    for env in (port, ref):
        env.set_attr("gravity", [9.8, 10.0, 11.0])
        env.set_attr("force_mag", 12.0)
    assert port.get_attr("gravity") == ref.get_attr("gravity") == (9.8, 10.0, 11.0)
    assert port.call("force_mag") == (12.0,) * 3
    assert_identical(port.call("get_wrapper_attr", "tau"), ref.call("get_wrapper_attr", "tau"))
    with pytest.raises(ValueError, match="length equal to the number of environments"):
        port.set_attr("gravity", [1.0, 2.0])
    actions = np.array([0, 1, 1])
    assert_identical(port.step(actions), ref.step(actions))
    port.close()
    ref.close()


def test_observation_mode_different_equals_jax():
    kwargs = {"vector_kwargs": {"observation_mode": "different"}}
    port = gym.make_vec("CartPole-v1", N, vectorization_mode="sync", **kwargs)
    ref = jgym.make_vec("CartPole-v1", N, vectorization_mode="sync", **kwargs)
    assert_same_space(port.observation_space, ref.observation_space)
    run_alike(port, ref, 40)
    with pytest.raises(ValueError, match="observation_mode"):
        gym.make_vec("CartPole-v1", 2, vectorization_mode="sync", vector_kwargs={"observation_mode": "bogus"})


@pytest.mark.parametrize("env_id,mode", [("CartPole-v1", "sync"), ("Acrobot-v1", None)])
def test_render_equals_jax(env_id, mode):
    """``render_mode`` with no vectorization mode goes to ``sync`` for an id
    without a vector entry point (Acrobot), as JAX's does."""
    port = gym.make_vec(env_id, 2, vectorization_mode=mode, render_mode="rgb_array")
    ref = jgym.make_vec(env_id, 2, vectorization_mode=mode, render_mode="rgb_array")
    assert isinstance(port, SyncVectorEnv)
    port.reset(seed=2)
    ref.reset(seed=2)
    frames = port.render()
    assert len(frames) == 2 and frames[0].dtype == np.uint8 and frames[0].ndim == 3
    assert_identical(frames, ref.render())
    port.close()
    ref.close()


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_spec_round_trip(mode):
    env = gym.make_vec("CartPole-v1", 2, vectorization_mode=mode)
    try:
        assert env.spec.kwargs["vectorization_mode"] == mode and env.spec.kwargs["num_envs"] == 2
        again = gym.make_vec(env.spec)
        try:
            assert type(again) is type(env) and again.num_envs == 2
            assert again.spec.kwargs == env.spec.kwargs
            assert_identical(again.reset(seed=4), env.reset(seed=4))
        finally:
            again.close(**({"terminate": True} if mode == "async" else {}))
    finally:
        env.close(**({"terminate": True} if mode == "async" else {}))


def test_blackjack_without_a_mode_is_sync():
    env = gym.make_vec("Blackjack-v1", 2)
    assert isinstance(env, SyncVectorEnv) and env.spec.kwargs["vectorization_mode"] == "sync"
    assert type(jgym.make_vec("Blackjack-v1", 2)).__name__ == "SyncVectorEnv"
    env.close()


def test_action_count_mismatch_raises():
    env = gym.make_vec("CartPole-v1", 3, vectorization_mode="sync")
    env.reset(seed=0)
    with pytest.raises(ValueError):
        env.step(np.array([0, 1]))
    env.close()


def _within(got, want, atol, rtol, label):
    err = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    bound = atol + rtol * np.abs(np.asarray(want, np.float64))
    assert (err <= bound).all(), f"{label}: {err.max()}"


def test_half_cheetah_on_the_cpu_twin_within_host_class_tolerance():
    port, ref = both("HalfCheetah-v5", device="cpu")
    assert all(env.unwrapped.device == torch.device("cpu") for env in port.envs)
    got, want = port.reset(seed=3), ref.reset(seed=3)
    assert_identical(got, want, "reset")  # the reset is drawn in float64 on both sides
    rng = np.random.default_rng(3)
    low, high = ref.single_action_space.low, ref.single_action_space.high
    for k in range(8):
        for penv, jenv in zip(port.envs, ref.envs):
            penv.unwrapped.set_state(*jenv.unwrapped.get_state())
        actions = rng.uniform(low, high, (N, low.size)).astype(np.float32)
        pobs, prew, pterm, ptrunc, pinfo = port.step(actions)
        jobs, jrew, jterm, jtrunc, jinfo = ref.step(actions)
        assert pobs.dtype == jobs.dtype and pobs.shape == jobs.shape
        _within(pobs, jobs, 1e-5 * np.abs(jobs).max() + 1e-6, 0.0, f"step {k} obs")
        for name, g, w in [("reward", prew, jrew)] + [(key, pinfo[key], jinfo[key]) for key in jinfo
                                                      if not key.startswith("_")]:
            for i in range(N):
                _within(g[i], w[i], 1e-5 * abs(w[i]) + 1e-6, 0.0, f"step {k} {name}[{i}]")
        assert list(pinfo) == list(jinfo)
        assert (pterm == jterm).all() and (ptrunc == jtrunc).all()
    port.close()
    ref.close()


def test_lunar_lander_on_the_cpu_twin_within_host_class_tolerance():
    port, ref = both("LunarLander-v3", device="cpu")
    got, want = port.reset(seed=5), ref.reset(seed=5)
    _within(got[0], want[0], 1e-6, 1e-6, "reset obs")
    rng = np.random.default_rng(5)
    for k in range(8):
        for penv, jenv in zip(port.envs, ref.envs):
            state = jenv.unwrapped.state
            penv.unwrapped.state = {key: torch.from_numpy(np.asarray(v).copy() if np.asarray(v).dtype == bool
                                                          else np.asarray(v).astype(np.float32))
                                    for key, v in state.items()}
        actions = rng.integers(0, 4, N)
        pobs, prew, pterm, ptrunc, _ = port.step(actions)
        jobs, jrew, jterm, jtrunc, _ = ref.step(actions)
        _within(pobs, jobs, 1e-6, 1e-6, f"step {k} obs")
        _within(prew, jrew, 1e-4, 1e-5, f"step {k} reward")
        assert (pterm == jterm).all() and (ptrunc == jtrunc).all()
        for penv, jenv in zip(port.envs, ref.envs):
            assert penv.unwrapped.np_random.bit_generator.state == jenv.unwrapped.np_random.bit_generator.state
    port.close()
    ref.close()
