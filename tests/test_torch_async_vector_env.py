"""The port's ``AsyncVectorEnv``: equal in every bit to the port's
``SyncVectorEnv`` and to the JAX package's ``AsyncVectorEnv`` on the same
seed and actions, with and without shared memory; the edge cases of
``tests/vector/test_async_edge_cases.py``; a ``spawn`` context whose workers
build HalfCheetah on the CPU through ``make_vec``'s picklable factory; and
the standard-library pickling used where cloudpickle is missing.

The numpy host classes run under the platform's default context (``fork``
on Linux), as the JAX package's tests run them. Every wait passes a
timeout and every env is closed with ``terminate=True``, so a hung worker
fails the test instead of hanging the run.
"""

import contextlib
import multiprocessing
import pickle
import sys
import time

import numpy as np
import pytest

import gymnasium_tpu as jgym
from gymnasium_tpu.vector import AutoresetMode as JMode
import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import error, spaces
from gymnasium_tpu_torch.envs.registration import SingleEnvFactory
from gymnasium_tpu_torch.error import AlreadyPendingCallError, ClosedEnvironmentError, NoAsyncCallError
from gymnasium_tpu_torch.vector import AsyncVectorEnv, SyncVectorEnv
from gymnasium_tpu_torch.vector.utils import CloudpickleWrapper
from tests.torch_compare import assert_identical

WAIT = 60.0
N = 4


@contextlib.contextmanager
def closing(*envs):
    try:
        yield envs if len(envs) > 1 else envs[0]
    finally:
        for env in envs:
            if isinstance(env, AsyncVectorEnv) or type(env).__name__ == "AsyncVectorEnv":
                env.close(terminate=True)
            else:
                env.close()


def reset(env, **kwargs):
    if isinstance(env, SyncVectorEnv) or type(env).__name__ == "SyncVectorEnv":
        return env.reset(**kwargs)
    env.reset_async(**kwargs)
    return env.reset_wait(timeout=WAIT)


def step(env, actions):
    if isinstance(env, SyncVectorEnv) or type(env).__name__ == "SyncVectorEnv":
        return env.step(actions)
    env.step_async(actions)
    return env.step_wait(timeout=WAIT)


def call(env, name, *args):
    env.call_async(name, *args)
    return env.call_wait(timeout=WAIT)


def run_alike(got_env, want_env, steps, seed=0):
    assert_identical(reset(got_env, seed=seed), reset(want_env, seed=seed), "reset")
    want_env.action_space.seed(1)
    ended = 0
    for k in range(steps):
        actions = want_env.action_space.sample()
        want = step(want_env, actions)
        assert_identical(step(got_env, actions), want, f"step {k}")
        ended += int((want[2] | want[3]).sum())
    return ended


@pytest.mark.parametrize("shared_memory", [True, False])
def test_async_equals_sync(shared_memory):
    with closing(gym.make_vec("CartPole-v1", N, vectorization_mode="async",
                              vector_kwargs={"shared_memory": shared_memory}),
                 gym.make_vec("CartPole-v1", N, vectorization_mode="sync")) as (async_env, sync_env):
        assert isinstance(async_env, AsyncVectorEnv)
        assert run_alike(async_env, sync_env, 150) > 0


@pytest.mark.parametrize("shared_memory", [True, False])
def test_async_equals_jax_async(shared_memory):
    kwargs = {"vectorization_mode": "async", "vector_kwargs": {"shared_memory": shared_memory}}
    with closing(gym.make_vec("CartPole-v1", N, **kwargs), jgym.make_vec("CartPole-v1", N, **kwargs)) as (port, ref):
        assert type(ref).__name__ == "AsyncVectorEnv"
        assert run_alike(port, ref, 150) > 0
        assert call(port, "gravity") == call(ref, "gravity")


def test_same_step_autoreset_equals_jax_async():
    """The async worker puts ``final_info`` before ``final_obs`` in the info
    (the sync env the other way round), as the JAX package's does."""
    port_kwargs = {"vector_kwargs": {"autoreset_mode": "SameStep"}}
    jax_kwargs = {"vector_kwargs": {"autoreset_mode": JMode.SAME_STEP}}
    with closing(gym.make_vec("CartPole-v1", N, vectorization_mode="async", **port_kwargs),
                 jgym.make_vec("CartPole-v1", N, vectorization_mode="async", **jax_kwargs)) as (port, ref):
        assert run_alike(port, ref, 100) > 0


def test_masked_reset_and_set_attr_equal_sync():
    with closing(gym.make_vec("CartPole-v1", N, vectorization_mode="async"),
                 gym.make_vec("CartPole-v1", N, vectorization_mode="sync")) as (async_env, sync_env):
        run_alike(async_env, sync_env, 5)
        mask = np.array([False, True, True, False])
        assert_identical(reset(async_env, seed=11, options={"reset_mask": mask.copy()}),
                         reset(sync_env, seed=11, options={"reset_mask": mask.copy()}))
        for env in (async_env, sync_env):
            env.set_attr("force_mag", [5.0, 10.0, 15.0, 20.0])
        assert call(async_env, "force_mag") == sync_env.get_attr("force_mag") == (5.0, 10.0, 15.0, 20.0)
        actions = np.array([1, 1, 0, 1])
        assert_identical(step(async_env, actions), step(sync_env, actions))


# -- edge cases (tests/vector/test_async_edge_cases.py) ---------------------


class SlowEnv(gym.Env):
    """A Box env whose reset and step sleep ``delay`` seconds, and whose
    step raises when ``boom``."""

    def __init__(self, delay=0.0, boom=False, observation_space=None):
        self.delay, self.boom = delay, boom
        self.observation_space = observation_space or spaces.Box(0.0, 1.0, (1,))
        self.action_space = spaces.Box(0.0, 1.0, (1,))

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        self.observation_space.seed(self.np_random_seed)
        time.sleep(self.delay)
        return self.observation_space.sample(), {}

    def step(self, action):
        if self.boom:
            raise RuntimeError("worker exploded")
        time.sleep(self.delay)
        return self.observation_space.sample(), 0.0, False, False, {}


@pytest.mark.parametrize("shared_memory", [True, False])
def test_step_wait_timeout(shared_memory):
    with closing(AsyncVectorEnv([lambda: SlowEnv(0.6) for _ in range(2)], shared_memory=shared_memory)) as envs:
        reset(envs, seed=0)
        envs.step_async(envs.action_space.sample())
        with pytest.raises(multiprocessing.TimeoutError):
            envs.step_wait(timeout=0.05)


def test_reset_wait_timeout():
    with closing(AsyncVectorEnv([lambda: SlowEnv(0.6) for _ in range(2)])) as envs:
        envs.reset_async(seed=0)
        with pytest.raises(multiprocessing.TimeoutError):
            envs.reset_wait(timeout=0.05)


def test_no_async_call_error():
    with closing(AsyncVectorEnv([SlowEnv for _ in range(2)])) as envs:
        with pytest.raises(NoAsyncCallError):
            envs.step_wait(timeout=WAIT)
        with pytest.raises(NoAsyncCallError):
            envs.reset_wait(timeout=WAIT)
        with pytest.raises(NoAsyncCallError):
            envs.call_wait(timeout=WAIT)


def test_already_pending_call_error():
    with closing(AsyncVectorEnv([lambda: SlowEnv(0.3) for _ in range(2)])) as envs:
        envs.reset_async(seed=0)
        with pytest.raises(AlreadyPendingCallError):
            envs.reset_async()
        envs.reset_wait(timeout=WAIT)
        envs.step_async(envs.action_space.sample())
        with pytest.raises(AlreadyPendingCallError):
            envs.step_async(envs.action_space.sample())
        with pytest.raises(AlreadyPendingCallError):
            envs.set_attr("delay", 0.0)
        envs.step_wait(timeout=WAIT)


def test_closed_env_raises():
    envs = AsyncVectorEnv([SlowEnv for _ in range(2)])
    with closing(envs):
        reset(envs, seed=0)
    with pytest.raises(ClosedEnvironmentError):
        envs.reset_async(seed=0)
    with pytest.raises(ClosedEnvironmentError):
        envs.step_async(envs.action_space.sample())


def test_terminate_close_kills_slow_workers():
    envs = AsyncVectorEnv([lambda: SlowEnv(5.0) for _ in range(2)])
    envs.reset_async(seed=0)
    start = time.perf_counter()
    envs.close(terminate=True)
    assert time.perf_counter() - start < 3.0, "terminate close should not wait out the step"
    assert all(not p.is_alive() for p in envs.processes)


def test_custom_nonflat_space_without_shared_memory():
    space = spaces.Dict({"a": spaces.Box(0.0, 1.0, (2,)), "b": spaces.Discrete(3)})
    with closing(AsyncVectorEnv([lambda: SlowEnv(observation_space=space) for _ in range(2)],
                                shared_memory=False)) as envs:
        obs, _ = reset(envs, seed=0)
        assert set(obs) == {"a", "b"} and obs["a"].shape == (2, 2) and obs["b"].shape == (2,)


class Custom(spaces.Space):
    pass


def test_custom_space_with_shared_memory_raises():
    with pytest.raises(ValueError, match="shared_memory=False"):
        AsyncVectorEnv([lambda: SlowEnv(observation_space=Custom()) for _ in range(2)])


def test_worker_exception_names_its_index():
    with closing(AsyncVectorEnv([lambda: SlowEnv(), lambda: SlowEnv(boom=True)])) as envs:
        reset(envs, seed=0)
        with pytest.warns(UserWarning, match="error from Worker-1"), pytest.raises(RuntimeError, match="exploded"):
            step(envs, envs.action_space.sample())
        with pytest.raises(ClosedEnvironmentError, match=r"worker\(s\) \[1\]"):
            step(envs, envs.action_space.sample())


def test_a_worker_that_cannot_build_its_env_raises_in_the_parent():
    def broken():
        raise RuntimeError("no env here")

    start = time.perf_counter()
    with pytest.warns(UserWarning, match="error from Worker-1"), pytest.raises(RuntimeError, match="no env here"):
        AsyncVectorEnv([SlowEnv, broken])
    assert time.perf_counter() - start < WAIT


# -- spawn and pickling ------------------------------------------------------


def test_spawn_half_cheetah_on_the_cpu_equals_sync():
    """Two spawned workers build HalfCheetah on the CPU from the pickled
    factory and step it as the sync env does, in every bit."""
    kwargs = {"device": "cpu"}
    with closing(gym.make_vec("HalfCheetah-v5", 2, vectorization_mode="async",
                              vector_kwargs={"context": "spawn"}, **kwargs),
                 gym.make_vec("HalfCheetah-v5", 2, vectorization_mode="sync", **kwargs)) as (async_env, sync_env):
        assert async_env.context == "spawn"
        assert call(async_env, "device") == (sync_env.envs[0].unwrapped.device,) * 2
        assert_identical(reset(async_env, seed=3), reset(sync_env, seed=3))
        rng = np.random.default_rng(3)
        for k in range(4):
            actions = rng.uniform(-1, 1, (2, 6)).astype(np.float32)
            assert_identical(step(async_env, actions), step(sync_env, actions), f"step {k}")


def test_make_vec_factory_pickles_with_the_standard_library():
    factory = SingleEnvFactory(gym.spec("CartPole-v1"), {"sutton_barto_reward": True}, ())
    rebuilt = pickle.loads(pickle.dumps(factory))
    sub_env = rebuilt()
    assert sub_env.unwrapped._sutton_barto_reward is True
    assert_identical(sub_env.reset(seed=1), factory().reset(seed=1))


def test_without_cloudpickle_a_closure_raises_naming_it(monkeypatch):
    monkeypatch.setitem(sys.modules, "cloudpickle", None)  # import cloudpickle raises ImportError
    factory = SingleEnvFactory(gym.spec("CartPole-v1"), {}, ())
    rebuilt = pickle.loads(pickle.dumps(CloudpickleWrapper(factory)))
    assert isinstance(rebuilt.fn, SingleEnvFactory)

    def local_factory():
        return gym.make("CartPole-v1")

    for fn in (local_factory, lambda: gym.make("CartPole-v1")):
        with pytest.raises(error.Error, match="cloudpickle is not installed"):
            pickle.dumps(CloudpickleWrapper(fn))
