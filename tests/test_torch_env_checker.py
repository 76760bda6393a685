"""The port's ``check_env``, ``check_environments_match`` and
``data_equivalence`` against the JAX package's.

``check_env`` over each id of the JAX package's own checker list raises
nothing and warns JAX's warning texts over JAX's env of that id; HalfCheetah
and LunarLander run their CPU twins (``device="cpu"``), and
``phys2d/CartPole-v1`` goes through the ``"torch"`` branch
(``ArrayConversion(env, "torch", "numpy")``) where JAX's goes through
``JaxToNumpy``. The broken envs of ``tests/utils/test_env_checker.py``, in
each package's classes, give JAX's exception and message.
``check_environments_match`` passes and fails as JAX's does in every
``info_comparison`` mode, with JAX's assertion texts.
"""

import types
import warnings

import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as gym
from gymnasium_tpu.utils.data_equivalence import data_equivalence as jdata_equivalence
from gymnasium_tpu.utils.env_checker import check_env as jcheck_env
from gymnasium_tpu.utils.env_match import check_environments_match as jmatch
from gymnasium_tpu_torch.utils import check_env, check_environments_match, data_equivalence
from gymnasium_tpu_torch.wrappers.array_conversion import ArrayConversion
from tests.testing_env import GenericTestEnv as JGenericTestEnv

# tests/envs/test_all_envs.py:93-113, the ids the JAX package checks
CHECKER_IDS = ("CartPole-v1", "Pendulum-v1", "MountainCar-v0", "Acrobot-v1", "FrozenLake-v1", "Taxi-v3",
               "CliffWalking-v1", "BlockchainCPD-v0", "HalfCheetah-v5", "LunarLander-v3", "phys2d/CartPole-v1")
CPU_TWINS = ("HalfCheetah-v5", "LunarLander-v3", "phys2d/CartPole-v1")


def outcome(fn) -> tuple:
    """``(exception type name, message, warning texts)`` of ``fn()``."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            fn()
            error = (None, None)
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            error = (type(e).__name__, str(e))
    return (*error, [str(w.message) for w in caught])


@pytest.mark.parametrize("env_id", CHECKER_IDS)
def test_check_env_warns_and_raises_as_jax(env_id):
    kwargs = {"device": "cpu"} if env_id in CPU_TWINS else {}
    port = gym.make(env_id, disable_env_checker=True, **kwargs).unwrapped
    ref = jgym.make(env_id, disable_env_checker=True).unwrapped
    got = outcome(lambda: check_env(port, skip_render_check=True))
    want = outcome(lambda: jcheck_env(ref, skip_render_check=True))
    assert got == want and want[0] is None
    port.close()
    ref.close()


def test_check_env_converts_a_torch_env_through_array_conversion(monkeypatch):
    seen = []
    original = ArrayConversion.step

    def step(self, action):
        out = original(self, action)
        seen.append((type(self.env).__name__, type(out[0])))
        return out

    monkeypatch.setattr(ArrayConversion, "step", step)
    env = gym.make("phys2d/CartPole-v1", device="cpu").unwrapped
    assert env.metadata["torch"] is True and isinstance(env.reset(seed=0)[0], torch.Tensor)
    check_env(env, skip_render_check=True)
    assert seen and all(s == ("FunctionalTorchEnv", np.ndarray) for s in seen)


# --- broken envs, in each package's classes ---------------------------------------


def generic_env_class(pkg, entry_point: str):
    """``tests.testing_env.GenericTestEnv`` over the package ``pkg``."""

    def basic_reset(self, *, seed=None, options=None):
        pkg.Env.reset(self, seed=seed)
        self.observation_space.seed(self.np_random_seed)
        return self.observation_space.sample(), {"options": options}

    def new_step(self, action):
        return self.observation_space.sample(), 0.0, False, False, {}

    class GenericTestEnv(pkg.Env):
        def __init__(self, action_space=None, observation_space=None, reset_func=basic_reset, step_func=new_step,
                     spec="default"):
            self.metadata = {"render_modes": ["rgb_array"], "render_fps": 30}
            self.render_mode = None
            if spec == "default":
                spec = pkg.envs.registration.EnvSpec("TestingEnv-v0", entry_point=entry_point, max_episode_steps=100)
            self.spec = spec
            self.observation_space = observation_space or pkg.spaces.Box(0, 1, (1,))
            self.action_space = action_space or pkg.spaces.Box(0, 1, (1,))
            self.reset = types.MethodType(reset_func, self)
            self.step = types.MethodType(step_func, self)

    return GenericTestEnv


PortGenericTestEnv = generic_env_class(gym, "tests.test_torch_env_checker:PortGenericTestEnv")
ENV_CLASSES = {"jax": (jgym, JGenericTestEnv), "torch": (gym, PortGenericTestEnv)}


def nondeterministic_reset(pkg, cls):
    def reset(self, *, seed=None, options=None):
        pkg.Env.reset(self, seed=seed)
        return np.random.default_rng().random(1).astype(np.float32), {}

    env = cls(reset_func=reset)
    env.spec = pkg.envs.registration.EnvSpec(id="Flaky-v0", entry_point="tests:Flaky")
    return env


def observation_outside_space(pkg, cls):
    def reset(self, *, seed=None, options=None):
        pkg.Env.reset(self, seed=seed)
        return np.array([100.0], dtype=np.float32), {}

    return cls(observation_space=pkg.spaces.Box(0.0, 1.0, (1,)), reset_func=reset)


def four_tuple_step(pkg, cls):
    def step(self, action):
        return self.observation_space.sample(), 0.0, False, {}

    return cls(step_func=step)


def non_dict_info(pkg, cls):
    def reset(self, *, seed=None, options=None):
        pkg.Env.reset(self, seed=seed)
        return self.observation_space.sample(), None

    return cls(reset_func=reset)


BROKEN = {"nondeterministic_reset": nondeterministic_reset, "observation_outside_space": observation_outside_space,
          "four_tuple_step": four_tuple_step, "non_dict_info": non_dict_info}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_broken_env_raises_jax_exception(case):
    port = BROKEN[case](*ENV_CLASSES["torch"])
    ref = BROKEN[case](*ENV_CLASSES["jax"])
    got = outcome(lambda: check_env(port, skip_render_check=True))
    want = outcome(lambda: jcheck_env(ref, skip_render_check=True))
    assert want[0] is not None and got == want


def test_conformant_generic_env_passes_as_jax():
    got = outcome(lambda: check_env(PortGenericTestEnv(), skip_render_check=True))
    want = outcome(lambda: jcheck_env(JGenericTestEnv(), skip_render_check=True))
    assert got == want and want[0] is None


def test_check_env_of_a_wrapped_env_warns_as_jax():
    got = outcome(lambda: check_env(gym.make("CartPole-v1"), warn=True, skip_render_check=True))
    want = outcome(lambda: jcheck_env(jgym.make("CartPole-v1"), warn=True, skip_render_check=True))
    assert got[:2] == want[:2] and len(got[2]) == len(want[2])
    # the texts name each package's own wrapper objects
    assert [w.replace("gymnasium_tpu_torch", "gymnasium_tpu") for w in got[2]] == want[2]


# --- check_environments_match ------------------------------------------------------


def info_env(pkg, cls, info: dict, shift: float = 0.0):
    """A generic env whose steps carry ``info`` and whose observations are
    its seeded samples plus ``shift``."""

    def step(self, action):
        return self.observation_space.sample() + np.float32(shift), 0.0, False, False, dict(info)

    env = cls(step_func=step)
    env.action_space = pkg.spaces.Discrete(2)
    return env


PAIRS = {
    "same": ({"a": 1}, {"a": 1}, 0.0),
    "superset": ({"a": 1}, {"a": 1, "b": 2}, 0.0),
    "value_differs": ({"a": 1}, {"a": 2}, 0.0),
    "keys_differ": ({"a": 1}, {"b": 1}, 0.0),
    "obs_shifted": ({"a": 1}, {"a": 1}, 1e-6),
}
MODES = (None, "equivalence", "superset", "skip", "keys-equivalence", "keys-superset")


@pytest.mark.parametrize("mode", MODES, ids=str)
@pytest.mark.parametrize("pair", sorted(PAIRS))
def test_environments_match_as_jax(pair, mode):
    info_a, info_b, shift = PAIRS[pair]

    def run(match, pkg_name):
        pkg, cls = ENV_CLASSES[pkg_name]
        env_a, env_b = info_env(pkg, cls, info_a), info_env(pkg, cls, info_b, shift)
        return [outcome(lambda: match(env_a, env_b, num_steps=5, seed=3, info_comparison=mode, atol=atol))
                for atol in (0.0, 1e-5)]

    assert run(check_environments_match, "torch") == run(jmatch, "jax")


@pytest.mark.parametrize("ids", [("CartPole-v1", "CartPole-v1"), ("CartPole-v1", "MountainCar-v0"),
                                 ("CartPole-v1", "CartPole-v0"), ("Pendulum-v1", "Pendulum-v1")])
def test_environments_match_over_registered_envs_as_jax(ids):
    got = outcome(lambda: check_environments_match(gym.make(ids[0]), gym.make(ids[1]), num_steps=60, seed=3))
    want = outcome(lambda: jmatch(jgym.make(ids[0]), jgym.make(ids[1]), num_steps=60, seed=3))
    assert got == want


def test_environments_match_reads_tensors_back():
    device_env = gym.make("phys2d/CartPole-v1", device="cpu")
    host_view = ArrayConversion(gym.make("phys2d/CartPole-v1", device="cpu"), "torch", "numpy")
    check_environments_match(device_env, host_view, num_steps=40, seed=1)
    shifted = gym.wrappers.TransformObservation(gym.make("phys2d/CartPole-v1", device="cpu"), lambda o: o + 1e-3,
                                                None)
    with pytest.raises(AssertionError, match="Reset obs differ"):
        check_environments_match(gym.make("phys2d/CartPole-v1", device="cpu"), shifted, num_steps=5, seed=1)
    check_environments_match(gym.make("phys2d/CartPole-v1", device="cpu"), shifted, num_steps=5, seed=1,
                             atol=2e-3)


# --- data_equivalence -----------------------------------------------------------------

EQUIVALENCE_CASES = {
    "nested": ({"x": np.arange(3), "y": ("s", 1.0, {"z": np.float32(2.0)})},
               {"x": np.arange(3), "y": ("s", 1.0, {"z": np.float32(2.0)})}),
    "value": ({"x": 1}, {"x": 2}),
    "key": ({"x": 1}, {"y": 1}),
    "length": ((1, 2), (1, 2, 3)),
    "array": (np.array([1, 2]), np.array([1, 3])),
    "dtype": (np.float32(1.0), np.float64(1.0)),
    "close": (np.array([1.0]), np.array([1.0 + 1e-7])),
    "far": (np.array([1.0]), np.array([1.1])),
    "object_array": (np.array([np.zeros(2), None], dtype=object), np.array([np.zeros(2), None], dtype=object)),
    "shape": (np.zeros((2, 1)), np.zeros((1, 2))),
    "list_vs_tuple": ([1, 2], (1, 2)),
}


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", sorted(EQUIVALENCE_CASES))
def test_data_equivalence_equals_jax(case, exact):
    a, b = EQUIVALENCE_CASES[case]
    assert data_equivalence(a, b, exact) is jdata_equivalence(a, b, exact)


NUMERIC_CASES = sorted(name for name, pair in EQUIVALENCE_CASES.items()
                       if all(isinstance(x, np.ndarray) and x.dtype != object for x in pair))


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("case", NUMERIC_CASES)
def test_data_equivalence_of_tensors_is_that_of_their_host_arrays(case, exact):
    a, b = EQUIVALENCE_CASES[case]
    assert data_equivalence(torch.as_tensor(a), torch.as_tensor(b), exact) is jdata_equivalence(a, b, exact)
