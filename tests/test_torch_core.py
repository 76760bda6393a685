"""The cases of ``tests/test_core.py`` run against both packages' Env/Wrapper
family: the JAX package's (``gymnasium_tpu.core``) and the port's copy
(``gymnasium_tpu_torch.core``). The test env seeds from the same numpy seeds
on both sides, so their ``np_random`` draws are equal exactly.
"""

import types

import numpy as np
import pytest

import gymnasium_tpu
import gymnasium_tpu_torch

PACKAGES = {"jax": gymnasium_tpu, "torch": gymnasium_tpu_torch}


def generic_env_class(gym):
    """``tests.testing_env.GenericTestEnv`` over the package ``gym``."""

    def basic_reset_func(self, *, seed=None, options=None):
        gym.Env.reset(self, seed=seed)
        self.observation_space.seed(self.np_random_seed)
        return self.observation_space.sample(), {"options": options}

    def new_step_func(self, action):
        return self.observation_space.sample(), 0.0, False, False, {}

    class GenericTestEnv(gym.Env):
        def __init__(self, action_space=None, observation_space=None, reset_func=basic_reset_func,
                     step_func=new_step_func, metadata=None, render_mode=None):
            self.metadata = metadata if metadata is not None else {"render_modes": ["rgb_array"], "render_fps": 30}
            self.render_mode = render_mode
            self.spec = gym.envs.registration.EnvSpec("TestingEnv-v0", entry_point="tests.testing_env:GenericTestEnv",
                                                      max_episode_steps=100)
            self.observation_space = observation_space or gym.spaces.Box(0, 1, (1,))
            self.action_space = action_space or gym.spaces.Box(0, 1, (1,))
            if reset_func is not None:
                self.reset = types.MethodType(reset_func, self)
            if step_func is not None:
                self.step = types.MethodType(step_func, self)

    return GenericTestEnv


@pytest.fixture(params=sorted(PACKAGES))
def gym(request):
    return PACKAGES[request.param]


@pytest.fixture
def GenericTestEnv(gym):
    return generic_env_class(gym)


# --- Env basics ---------------------------------------------------------------


def test_np_random_lazy_seeding(GenericTestEnv):
    env = GenericTestEnv()
    rng1 = env.np_random
    assert isinstance(rng1, np.random.Generator)
    assert env.np_random is rng1


def test_reset_seed_sets_np_random_seed(GenericTestEnv):
    env = GenericTestEnv()
    env.reset(seed=123)
    assert env.np_random_seed == 123
    first = env.np_random.random()
    env.reset(seed=123)
    assert env.np_random.random() == first


def test_reset_without_seed_keeps_rng(GenericTestEnv):
    env = GenericTestEnv()
    env.reset(seed=5)
    rng = env.np_random
    env.reset()
    assert env.np_random is rng


def test_np_random_setter_invalidates_seed(GenericTestEnv):
    env = GenericTestEnv()
    env.reset(seed=1)
    env.np_random = np.random.default_rng(999)
    assert env.np_random_seed == -1


def test_context_manager_closes(GenericTestEnv):
    closed = []
    env = GenericTestEnv()
    env.close = lambda: closed.append(True)
    with env as e:
        assert e is env
    assert closed == [True]


def test_str_contains_class_name(GenericTestEnv):
    assert "GenericTestEnv" in str(GenericTestEnv())


def test_unwrapped_identity(GenericTestEnv):
    env = GenericTestEnv()
    assert env.unwrapped is env


def test_np_random_draws_equal_across_packages():
    a, b = (generic_env_class(gym)() for gym in (gymnasium_tpu, gymnasium_tpu_torch))
    obs_a, _ = a.reset(seed=3)
    obs_b, _ = b.reset(seed=3)
    np.testing.assert_array_equal(obs_a, obs_b)
    np.testing.assert_array_equal(a.np_random.random(16), b.np_random.random(16))
    np.testing.assert_array_equal(a.step(None)[0], b.step(None)[0])
    assert a.np_random_seed == b.np_random_seed == 3


# --- Wrapper delegation -------------------------------------------------------


@pytest.fixture
def NoopWrapper(gym):
    class _NoopWrapper(gym.Wrapper):
        pass

    return _NoopWrapper


def test_wrapper_delegates_spaces_and_metadata(GenericTestEnv, NoopWrapper):
    env = GenericTestEnv()
    wrapped = NoopWrapper(env)
    assert wrapped.observation_space is env.observation_space
    assert wrapped.action_space is env.action_space
    assert wrapped.metadata == env.metadata
    assert wrapped.unwrapped is env


def test_wrapper_space_override_is_sticky(gym, GenericTestEnv, NoopWrapper):
    wrapped = NoopWrapper(GenericTestEnv())
    new_space = gym.spaces.Discrete(7)
    wrapped.action_space = new_space
    assert wrapped.action_space is new_space
    assert wrapped.env.action_space is not new_space


def test_wrapper_getattr_falls_through(GenericTestEnv, NoopWrapper):
    env = GenericTestEnv()
    env.custom_attribute = 42
    wrapped = NoopWrapper(env)
    with pytest.raises(AttributeError):
        wrapped.custom_attribute
    assert wrapped.get_wrapper_attr("custom_attribute") == 42


def test_wrapper_getattr_blocks_private(GenericTestEnv, NoopWrapper):
    wrapped = NoopWrapper(GenericTestEnv())
    with pytest.raises(AttributeError):
        wrapped._nonexistent_private


def test_has_get_set_wrapper_attr(GenericTestEnv, NoopWrapper):
    env = GenericTestEnv()
    env.depth_marker = "inner"
    outer = NoopWrapper(NoopWrapper(env))
    assert outer.has_wrapper_attr("depth_marker")
    assert outer.get_wrapper_attr("depth_marker") == "inner"
    outer.set_wrapper_attr("depth_marker", "changed")
    assert env.depth_marker == "changed"
    assert not outer.has_wrapper_attr("never_set")
    with pytest.raises(AttributeError):
        outer.get_wrapper_attr("never_set")


def test_wrapper_np_random_proxies_to_unwrapped(GenericTestEnv, NoopWrapper):
    env = GenericTestEnv()
    wrapped = NoopWrapper(env)
    wrapped.reset(seed=77)
    assert env.np_random_seed == 77
    assert wrapped.np_random is env.np_random


def test_wrapper_repr(GenericTestEnv, NoopWrapper):
    wrapped = NoopWrapper(GenericTestEnv())
    assert "_NoopWrapper" in repr(wrapped)
    assert "GenericTestEnv" in repr(wrapped)


# --- one-hook wrappers ---------------------------------------------------------


def test_observation_wrapper_hook(gym, GenericTestEnv):
    class PlusOne(gym.ObservationWrapper):
        def observation(self, observation):
            return observation + 1

    env = GenericTestEnv(
        reset_func=lambda self, seed=None, options=None: (np.float32(0.0), {}),
        step_func=lambda self, action: (np.float32(1.0), 0.5, False, False, {}),
    )
    wrapped = PlusOne(env)
    obs, _ = wrapped.reset()
    assert obs == 1.0
    obs, reward, *_ = wrapped.step(0)
    assert obs == 2.0 and reward == 0.5


def test_reward_wrapper_hook(gym, GenericTestEnv):
    class Double(gym.RewardWrapper):
        def reward(self, reward):
            return 2 * reward

    env = GenericTestEnv(step_func=lambda self, action: (self.observation_space.sample(), 1.5, False, False, {}))
    wrapped = Double(env)
    wrapped.reset()
    _, reward, *_ = wrapped.step(0)
    assert reward == 3.0


def test_action_wrapper_hook(gym, GenericTestEnv):
    seen = []

    class Shift(gym.ActionWrapper):
        def action(self, action):
            return action + 10

    def record_step(self, action):
        seen.append(action)
        return self.observation_space.sample(), 0.0, False, False, {}

    env = GenericTestEnv(step_func=record_step)
    wrapped = Shift(env)
    wrapped.reset()
    wrapped.step(1)
    assert seen == [11]


# --- wrapper spec / RecordConstructorArgs --------------------------------------

SINGLE_ENV_ID = {"jax": "CartPole-v1", "torch": "phys2d/CartPole-v1"}
MAKE_KWARGS = {"jax": {}, "torch": {"device": "cpu"}}


@pytest.fixture
def made(gym):
    key = "jax" if gym is gymnasium_tpu else "torch"
    env = gym.make(SINGLE_ENV_ID[key], **MAKE_KWARGS[key])
    yield env
    env.close()


def test_spec_appends_wrapper_spec_for_recorded_wrappers(gym, made):
    from gymnasium_tpu_torch.utils.record_constructor import RecordConstructorArgs as TorchArgs
    from gymnasium_tpu.utils.record_constructor import RecordConstructorArgs as JaxArgs

    args_cls = JaxArgs if gym is gymnasium_tpu else TorchArgs

    class Scale(gym.RewardWrapper, args_cls):
        def __init__(self, env, scale: float):
            args_cls.__init__(self, scale=scale)
            gym.RewardWrapper.__init__(self, env)
            self.scale = scale

        def reward(self, reward):
            return self.scale * reward

    spec = Scale(made, scale=0.5).spec
    assert spec is not None
    assert [(ws.name, ws.kwargs) for ws in spec.additional_wrappers] == [("Scale", {"scale": 0.5})]


def test_unrecorded_wrapper_spec_raises_or_skips(made, NoopWrapper):
    wrapped = NoopWrapper(made)
    try:
        spec = wrapped.spec
        assert all(ws.name != "_NoopWrapper" for ws in spec.additional_wrappers)
    except Exception:
        pass
