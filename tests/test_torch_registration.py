"""The port's registry: the cases of ``tests/envs/test_registration.py`` run
against ``gymnasium_tpu_torch``, and the registry held against the JAX
package's (ids, step limits, thresholds, kwargs, spaces).

``make_vec(id)`` resolves to the ``torch`` mode wherever the spec has a
``torch_entry_point``; everything here runs with ``device="cpu"``.
"""

import warnings

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch import error
from gymnasium_tpu_torch.envs.registration import (
    EnvSpec,
    VectorizeMode,
    WrapperSpec,
    find_highest_version,
    get_env_id,
    load_env_creator,
    namespace,
    parse_env_id,
    register,
    registry,
    spec,
)
from gymnasium_tpu_torch.vector import TorchVectorEnv
from tests.torch_compare import assert_same_space

CPU = {"device": "cpu"}
TORCH_IDS = sorted(id_ for id_, s in registry.items() if s.torch_entry_point is not None)
PORT_SINGLE = ("gymnasium_tpu_torch.envs.functional_torch_env:",)


class PortDummyEnv(gym.Env):
    """A minimal env of the port for registration tests."""

    metadata = {"render_modes": [], "render_fps": 30}

    def __init__(self):
        self.observation_space = gym.spaces.Box(0, 1, (1,))
        self.action_space = gym.spaces.Discrete(2)

    def reset(self, *, seed=None, options=None):
        super().reset(seed=seed)
        return np.zeros(1, np.float32), {}

    def step(self, action):
        return np.zeros(1, np.float32), 0.0, False, False, {}


# --- the cases of tests/envs/test_registration.py ------------------------------


def test_parse_env_id():
    assert parse_env_id("CartPole-v1") == (None, "CartPole", 1)
    assert parse_env_id("phys2d/CartPole-v0") == ("phys2d", "CartPole", 0)
    assert parse_env_id("Taxi") == (None, "Taxi", None)
    with pytest.raises(error.Error):
        parse_env_id("not/valid/id-v1!!!")


def test_get_env_id_roundtrip():
    for env_id in ("CartPole-v1", "phys2d/Pendulum-v0", "Blackjack-v1"):
        assert get_env_id(*parse_env_id(env_id)) == env_id


def test_find_highest_version():
    assert find_highest_version(None, "CartPole") == 1
    assert find_highest_version("tabular", "Blackjack") == 0


def test_spec_json_roundtrip():
    env_spec = spec("CartPole-v1")
    restored = EnvSpec.from_json(env_spec.to_json())
    assert restored == env_spec
    assert restored.torch_entry_point == "gymnasium_tpu_torch.envs.phys2d.cartpole:CartPoleFunctional"


def test_make_resolves_latest_version():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        env = gym.make("phys2d/CartPole", device="cpu")
    assert env.spec.id == "phys2d/CartPole-v1"
    env.close()


def test_make_unknown_env_errors():
    with pytest.raises(error.UnregisteredEnv):
        gym.make("DefinitelyNotAnEnv-v0")
    with pytest.raises(error.NamespaceNotFound):
        gym.make("nope/CartPole-v1")
    with pytest.raises(error.VersionNotFound):
        gym.make("CartPole-v99")


def test_make_applies_wrapper_onion():
    from gymnasium_tpu_torch.wrappers.common import OrderEnforcing, PassiveEnvChecker, TimeLimit

    env = gym.make("phys2d/CartPole-v1", device="cpu")
    assert isinstance(env, TimeLimit)
    assert isinstance(env.env, OrderEnforcing)
    assert isinstance(env.env.env, PassiveEnvChecker)
    env.close()
    env = gym.make("phys2d/CartPole-v1", disable_env_checker=True, device="cpu")
    assert isinstance(env.env, OrderEnforcing)
    assert not isinstance(env.env.env, PassiveEnvChecker)
    env.close()


def test_make_max_episode_steps_override():
    env = gym.make("phys2d/CartPole-v1", max_episode_steps=7, device="cpu")
    env.reset(seed=0)
    for _ in range(7):
        _, _, te, tr, _ = env.step(0)
        if te:
            break
    assert tr or te
    env.close()


def test_register_namespace_context():
    with namespace("testns"):
        register(id="Dummy-v0", entry_point="tests.test_torch_registration:PortDummyEnv")
    assert "testns/Dummy-v0" in registry
    env = gym.make("testns/Dummy-v0", disable_env_checker=True)
    env.close()
    del registry["testns/Dummy-v0"]


def test_additional_wrappers_reconstruction():
    wrapper_spec = WrapperSpec(
        name="TimeLimit",
        entry_point="gymnasium_tpu_torch.wrappers.common:TimeLimit",
        kwargs={"max_episode_steps": 3},
    )
    register(
        id="WrappedDummy-v0",
        entry_point="tests.test_torch_registration:PortDummyEnv",
        additional_wrappers=(wrapper_spec,),
    )
    try:
        env = gym.make("WrappedDummy-v0", disable_env_checker=True)
        env.reset()
        for _ in range(3):
            _, _, te, tr, _ = env.step(env.action_space.sample())
        assert tr
        env.close()
    finally:
        del registry["WrappedDummy-v0"]


@pytest.mark.parametrize("mode", ["torch", "vector_entry_point", None])
def test_make_vec_modes(mode):
    kwargs = {"vector_kwargs": CPU} if mode != "vector_entry_point" else CPU
    env = gym.make_vec("phys2d/CartPole-v1", num_envs=2, vectorization_mode=mode, **kwargs)
    obs, _ = env.reset(seed=0)
    assert tuple(obs.shape) == (2, 4) and isinstance(env, TorchVectorEnv)
    env.close()


def test_make_vec_invalid_mode():
    with pytest.raises(error.Error):
        gym.make_vec("CartPole-v1", num_envs=2, vectorization_mode="bogus")
    assert VectorizeMode("torch") is VectorizeMode.TORCH
    assert "jax" not in [m.value for m in VectorizeMode]


def test_pprint_registry():
    output = gym.pprint_registry(disable_print=True)
    assert "CartPole-v1" in output
    assert "tabular" in output
    assert output == jgym.pprint_registry(disable_print=True)


def test_wrapper_spec_in_env_spec():
    from gymnasium_tpu_torch.wrappers import RecordEpisodeStatistics

    env = gym.make("phys2d/CartPole-v1", device="cpu")
    wrapped = RecordEpisodeStatistics(env, buffer_length=5)
    assert wrapped.spec is not None
    names = [w.name for w in wrapped.spec.additional_wrappers]
    assert "RecordEpisodeStatistics" in names
    env.close()


# --- the registry against the JAX package's --------------------------------------


def test_id_set_and_fields_equal_jax():
    assert sorted(registry) == sorted(jgym.registry) and len(registry) == 66
    for env_id, ref in jgym.registry.items():
        got = registry[env_id]
        for field in ("max_episode_steps", "reward_threshold", "nondeterministic", "kwargs", "order_enforce",
                      "disable_env_checker", "additional_wrappers"):
            assert getattr(got, field) == getattr(ref, field), (env_id, field)


def test_every_jax_entry_point_has_a_torch_entry_point():
    with_jax = sorted(id_ for id_, s in jgym.registry.items() if s.jax_entry_point is not None)
    assert TORCH_IDS == with_jax and len(with_jax) == 46
    for env_id in with_jax:
        want = jgym.registry[env_id].jax_entry_point.replace("gymnasium_tpu.", "gymnasium_tpu_torch.", 1)
        assert registry[env_id].torch_entry_point == want
        assert isinstance(load_env_creator(want), type)


@pytest.mark.parametrize("env_id", TORCH_IDS)
def test_make_vec_builds_each_torch_id_with_jax_spaces_and_limit(env_id):
    env = gym.make_vec(env_id, 4, vector_kwargs=CPU)
    ref = jgym.make_vec(env_id, 4, vectorization_mode="jax")
    assert isinstance(env, TorchVectorEnv) and env.device == torch.device("cpu")
    assert env.spec.kwargs["vectorization_mode"] == "torch"
    assert env.time_limit == ref.time_limit == registry[env_id].max_episode_steps
    port_obs, ref_obs = env.single_observation_space, ref.single_observation_space
    if env_id.split("-")[0] in MUJOCO_FLOAT32_OBS:
        # the port's robots declare the float32 they return, JAX's float64 (ROADMAP §3)
        assert port_obs.dtype == np.float32 and ref_obs.dtype == np.float64 and port_obs.shape == ref_obs.shape
    else:
        assert_same_space(port_obs, ref_obs)
    assert_same_space(env.single_action_space, ref.single_action_space)
    obs, _ = env.reset(seed=0)
    assert tuple(obs.shape) == (4,) + port_obs.shape


MUJOCO_FLOAT32_OBS = {"Reacher", "Pusher", "InvertedPendulum", "InvertedDoublePendulum", "HalfCheetah", "Hopper",
                      "Swimmer", "Walker2d", "Ant", "Humanoid", "HumanoidStandup"}


def test_make_vec_equals_a_hand_built_env_bit_for_bit():
    from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional

    made = gym.make_vec("CartPole-v1", 8, vector_kwargs=CPU)
    hand = TorchVectorEnv(CartPoleFunctional(), 8, max_episode_steps=500, device="cpu")
    again = gym.make_vec(made.spec)
    assert again.spec.kwargs == made.spec.kwargs and again.time_limit == 500
    outs = [env.reset(seed=0)[0] for env in (made, hand, again)]
    gen = torch.Generator().manual_seed(1)
    for _ in range(40):
        action = made.single_action_space.sample_torch(gen, (8,))
        outs = [env.step(action) for env in (made, hand, again)]
        for got in (outs[0], outs[2]):
            for a, b in zip(got[:4], outs[1][:4]):
                assert a.dtype == b.dtype and torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    assert torch.equal(made.carry.steps, hand.carry.steps)


def test_every_string_entry_point_loads():
    """Every id whose ``entry_point`` is a string names a callable the port
    has, at JAX's entry point with the package renamed (the adapters' at the
    port's own module)."""
    string_ids = sorted(id_ for id_, s in registry.items() if isinstance(s.entry_point, str))
    assert len(string_ids) == 47
    for env_id in string_ids:
        entry_point = registry[env_id].entry_point
        assert callable(load_env_creator(entry_point)), env_id
        if not entry_point.startswith(PORT_SINGLE):
            assert entry_point == jgym.registry[env_id].entry_point.replace("gymnasium_tpu.", "gymnasium_tpu_torch.", 1)


BOX2D_IDS = ("LunarLander-v3", "LunarLanderContinuous-v3", "BipedalWalker-v3", "BipedalWalkerHardcore-v3",
             "CarRacing-v3")


def _wrapper_names(env) -> list[str]:
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names + [type(env).__name__]


@pytest.mark.parametrize("env_id", BOX2D_IDS)
def test_make_of_a_box2d_id_matches_jax(env_id):
    """``make`` of each Box2D id builds the port's host class with JAX's
    wrappers, spaces and step limit; the reset and one step agree with
    JAX's (the planar ids within 1e-5 + 1e-5 |JAX| per element, CarRacing
    bit for bit) and the generators stay in step."""
    kwargs = {} if env_id == "CarRacing-v3" else CPU
    port, jax_env = gym.make(env_id, **kwargs), jgym.make(env_id)
    assert _wrapper_names(port) == _wrapper_names(jax_env)
    assert port.spec.max_episode_steps == jax_env.spec.max_episode_steps
    assert_same_space(port.action_space, jax_env.action_space)
    assert_same_space(port.observation_space, jax_env.observation_space)
    action = jax_env.action_space.sample()
    for got, want in ((port.reset(seed=0)[0], jax_env.reset(seed=0)[0]),
                      (port.step(action)[0], jax_env.step(action)[0])):
        assert got.dtype == want.dtype and got.shape == want.shape
        if env_id == "CarRacing-v3":
            np.testing.assert_array_equal(got, want)
        else:
            assert (np.abs(got - want) <= 1e-5 + 1e-5 * np.abs(want)).all()
    assert port.unwrapped.np_random.bit_generator.state == jax_env.unwrapped.np_random.bit_generator.state


@pytest.mark.parametrize("env_id", sorted(id_ for id_, s in registry.items() if callable(s.entry_point)))
def test_retired_ids_raise_as_jax_does(env_id):
    with pytest.raises(ImportError) as got:
        gym.make(env_id)
    with pytest.raises(ImportError) as want:
        jgym.make(env_id)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("env_id", sorted(id_ for id_, s in registry.items()
                                          if isinstance(s.entry_point, str) and s.entry_point.startswith(PORT_SINGLE)))
def test_make_of_each_adapter_id_steps(env_id):
    env = gym.make(env_id, device="cpu")
    obs, _ = env.reset(seed=0)
    assert env.observation_space.contains(obs)
    obs, reward, term, trunc, _ = env.step(env.action_space.sample())
    assert isinstance(reward, float) and env.observation_space.contains(obs)
    env.close()
