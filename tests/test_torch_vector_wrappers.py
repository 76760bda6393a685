"""The port's vector wrappers against the JAX package's.

Over ``make_vec(id, n, vectorization_mode="sync")``, numpy on both sides,
each wrapper of ``tests/wrappers/test_vector_wrappers.py`` (and the other
names of the catalog) over the port's env equals the same wrapper over
JAX's env in every bit: spaces, every reset and step, infos and their masks
(``assert_identical``), from one seed and one action stream. The one value
left out is ``info["episode"]["t"]``, the wall-clock length of an episode,
held to its type and shape only.

Over a ``TorchVectorEnv`` on the CPU each wrapper runs as it runs on the
card, and is held to JAX's wrapper over :class:`Replay`, a JAX vector env
defined here that hands JAX the port env's own outputs as JAX device
arrays (what ``JaxVectorEnv`` returns) and checks that the actions reaching
it are the ones that reached the port's env. Every output agrees within
``TOL`` and has JAX's kind: a tensor where JAX passes a device array
through, numpy where JAX returns numpy. ``FlattenObservation`` and
``DtypeObservation`` over an unchanged space raise ``TypeError`` there, as
JAX's do over its device env, and leave the env's observation as it was.
"""

import copy
import io
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu.vector as jvector
import gymnasium_tpu.wrappers.vector as JV
import gymnasium_tpu_torch as gym
import gymnasium_tpu_torch.vector as tvector
import gymnasium_tpu_torch.wrappers.vector as TV
from tests.torch_compare import assert_identical, assert_same_space

N = 4
TOL = 1e-6

# name -> (env id, envs, steps, wrap(V, env) with V the package's vector wrappers)
SYNC_CASES = {
    "RecordEpisodeStatistics": ("CartPole-v1", N, 120, lambda V, e: V.RecordEpisodeStatistics(e)),
    "DictInfoToList": ("CartPole-v1", N, 120, lambda V, e: V.DictInfoToList(V.RecordEpisodeStatistics(e))),
    "NormalizeObservation": ("CartPole-v1", N, 60, lambda V, e: V.NormalizeObservation(e)),
    "NormalizeReward": ("Pendulum-v1", N, 60, lambda V, e: V.NormalizeReward(e, gamma=0.95)),
    "TransformObservation": ("CartPole-v1", N, 30, lambda V, e: V.TransformObservation(e, lambda o: o * 2.0 + 1.0)),
    "FilterObservation": ("Blackjack-v1", N, 30, lambda V, e: V.FilterObservation(e, [0, 2])),
    "FlattenObservation": ("CartPole-v1", N, 30, lambda V, e: V.FlattenObservation(e)),
    "FlattenObservation[Tuple]": ("Blackjack-v1", N, 30, lambda V, e: V.FlattenObservation(e)),
    "GrayscaleObservation": ("CarRacing-v3", 2, 4, lambda V, e: V.GrayscaleObservation(e)),
    "ResizeObservation": ("CarRacing-v3", 2, 4, lambda V, e: V.ResizeObservation(e, (32, 24))),
    "ReshapeObservation": ("CartPole-v1", N, 30, lambda V, e: V.ReshapeObservation(e, (2, 2))),
    "RescaleObservation": ("Pendulum-v1", N, 30, lambda V, e: V.RescaleObservation(e, -1.0, 1.0)),
    "DtypeObservation": ("CartPole-v1", N, 30, lambda V, e: V.DtypeObservation(e, np.float64)),
    "DtypeObservation[same]": ("CartPole-v1", N, 30, lambda V, e: V.DtypeObservation(e, np.float32)),
    "TransformAction": ("Pendulum-v1", N, 30, lambda V, e: V.TransformAction(e, lambda a: 0.5 * a)),
    "ClipAction": ("Pendulum-v1", N, 30, lambda V, e: V.ClipAction(e)),
    "RescaleAction": ("Pendulum-v1", N, 30, lambda V, e: V.RescaleAction(e, -1.0, 1.0)),
    "TransformReward": ("CartPole-v1", N, 30, lambda V, e: V.TransformReward(e, lambda r: 2 * r)),
    "ClipReward": ("Pendulum-v1", N, 30, lambda V, e: V.ClipReward(e, -1.0, 0.0)),
}


def without_times(x):
    """``x`` with each episode statistics' wall-clock ``t`` replaced by its
    type, dtype and shape."""
    if isinstance(x, dict):
        out = {k: without_times(v) for k, v in x.items()}
        if {"r", "l", "t"} <= set(x):
            t = np.asarray(x["t"])
            out["t"] = (type(x["t"]).__name__, str(t.dtype), t.shape)
        return out
    if isinstance(x, (tuple, list)):
        return type(x)(without_times(v) for v in x)
    return x


def trajectory(env, actions, seed=0) -> list:
    """``env.reset(seed=seed)`` and one step a batch of ``actions``."""
    out = [env.reset(seed=seed)]
    out += [env.step(a) for a in actions]
    return out


@pytest.mark.parametrize("name", sorted(SYNC_CASES))
def test_wrapper_over_sync_equals_jax(name):
    env_id, n, steps, wrap = SYNC_CASES[name]
    port = wrap(TV, gym.make_vec(env_id, n, vectorization_mode="sync"))
    ref = wrap(JV, jgym.make_vec(env_id, n, vectorization_mode="sync"))
    assert type(port).__name__ == type(ref).__name__
    for attr in ("observation_space", "single_observation_space", "action_space", "single_action_space"):
        assert_same_space(getattr(port, attr), getattr(ref, attr), attr)
    ref.action_space.seed(1)
    actions = [ref.action_space.sample() for _ in range(steps)]
    got, want = trajectory(port, actions), trajectory(ref, actions)
    for k, (a, b) in enumerate(zip(got, want)):
        assert_identical(without_times(a), without_times(b), f"{name} call {k}")
    if name == "RecordEpisodeStatistics":
        assert port.episode_count == ref.episode_count > 0
        assert list(port.return_queue) == list(ref.return_queue)
        assert list(port.length_queue) == list(ref.length_queue)
    port.close()
    ref.close()


# --- over a TorchVectorEnv on the CPU ----------------------------------------


class _JaxUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module == "gymnasium_tpu_torch" or module.startswith("gymnasium_tpu_torch."):
            module = "gymnasium_tpu" + module[len("gymnasium_tpu_torch"):]
        return super().find_class(module, name)


def to_jax_space(space):
    """The JAX package's counterpart of a port space."""
    return _JaxUnpickler(io.BytesIO(pickle.dumps(space))).load()


def as_numpy(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def to_jax(x):
    """The port env's output as ``JaxVectorEnv`` gives it: tensors as JAX
    device arrays, dicts and tuples entry by entry."""
    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.numpy())
    if isinstance(x, dict):
        return {k: to_jax(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return tuple(to_jax(v) for v in x)
    return x


class Tap(tvector.VectorWrapper):
    """Records what the port env is given and a copy of what it returns (the
    wrappers above write into its infos)."""

    def __init__(self, env):
        super().__init__(env)
        self.calls = []

    def reset(self, *, seed=None, options=None):
        out = self.env.reset(seed=seed, options=options)
        self.calls.append((None, copy.deepcopy(out)))
        return out

    def step(self, actions):
        out = self.env.step(actions)
        self.calls.append((copy.deepcopy(actions), copy.deepcopy(out)))
        return out


class Replay(jvector.VectorEnv):
    """A JAX vector env that replays a :class:`Tap`'s calls: each reset and
    step returns the port env's outputs as device arrays, after checking
    that a step's actions are the port env's."""

    def __init__(self, tap: Tap):
        self.num_envs = tap.num_envs
        self.single_observation_space = to_jax_space(tap.single_observation_space)
        self.single_action_space = to_jax_space(tap.single_action_space)
        self.observation_space = jvector.utils.batch_space(self.single_observation_space, self.num_envs)
        self.action_space = jvector.utils.batch_space(self.single_action_space, self.num_envs)
        self.metadata = {"autoreset_mode": jvector.AutoresetMode.NEXT_STEP}
        self._calls = iter(tap.calls)

    def reset(self, *, seed=None, options=None):
        actions, out = next(self._calls)
        assert actions is None, "the port env was stepped where JAX's is reset"
        return to_jax(out)

    def step(self, actions):
        want, out = next(self._calls)
        assert want is not None, "the port env was reset where JAX's is stepped"
        np.testing.assert_array_equal(np.asarray(actions), as_numpy(want))
        return to_jax(out)


def assert_like_jax(got, want, path="x"):
    """``got`` (the port's) is of ``want``'s kind (JAX's): a tensor where JAX
    has a device array, numpy of the same dtype where JAX has numpy, the
    same containers and scalar types; and every value within ``TOL``."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and list(got) == list(want), f"{path}: keys {list(got)} vs {list(want)}"
        for key in want:
            assert_like_jax(got[key], want[key], f"{path}[{key!r}]")
        return
    if isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), f"{path}: {type(got)} vs {type(want)}"
        for i, (a, b) in enumerate(zip(got, want)):
            assert_like_jax(a, b, f"{path}[{i}]")
        return
    if type(want).__module__.startswith("jax"):
        assert isinstance(got, torch.Tensor), f"{path}: {type(got).__name__} where JAX passes a device array"
        a = got.numpy()
    else:
        assert type(got) is type(want), f"{path}: {type(got).__name__} vs {type(want).__name__}"
        a = np.asarray(got)
    b = np.asarray(want)
    assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}"
    if np.issubdtype(b.dtype, np.floating):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL, err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


def torch_env(env_id, n, limit):
    env = gym.make_vec(env_id, n, vector_kwargs={"device": "cpu", "max_episode_steps": limit})
    assert isinstance(env, tvector.TorchVectorEnv)
    return env


def wide_actions(space, n, steps, seed=0):
    """``steps`` batches of actions, a Box's reaching one unit past its
    bounds on each side."""
    rng = np.random.default_rng(seed)
    if hasattr(space, "low"):
        return rng.uniform(space.low - 1.0, space.high + 1.0, (steps, n, *space.shape)).astype(np.float32)
    return rng.integers(0, space.n, (steps, n))


# name -> (env id, envs, step limit, steps, wrap(V, env))
TORCH_CASES = {
    "RecordEpisodeStatistics": ("CartPole-v1", N, 10, 24, lambda V, e: V.RecordEpisodeStatistics(e)),
    "DictInfoToList": ("CartPole-v1", N, 10, 24, lambda V, e: V.DictInfoToList(V.RecordEpisodeStatistics(e))),
    "NormalizeObservation": ("Pendulum-v1", N, 200, 20, lambda V, e: V.NormalizeObservation(e)),
    "NormalizeReward": ("Pendulum-v1", N, 200, 20, lambda V, e: V.NormalizeReward(e, gamma=0.95)),
    "TransformObservation": ("Pendulum-v1", N, 200, 10, lambda V, e: V.TransformObservation(e, lambda o: o * 2.0 + 1.0)),
    "FlattenObservation": ("CarRacing-v3", 2, 50, 2, lambda V, e: V.FlattenObservation(e)),
    "GrayscaleObservation": ("CarRacing-v3", 2, 50, 2, lambda V, e: V.GrayscaleObservation(e, keep_dim=True)),
    "ResizeObservation": ("CarRacing-v3", 2, 50, 2, lambda V, e: V.ResizeObservation(e, (32, 24))),
    "ReshapeObservation": ("Pendulum-v1", N, 200, 10, lambda V, e: V.ReshapeObservation(e, (3, 1))),
    "RescaleObservation": ("Pendulum-v1", N, 200, 10, lambda V, e: V.RescaleObservation(e, -1.0, 1.0)),
    "DtypeObservation": ("Pendulum-v1", N, 200, 10, lambda V, e: V.DtypeObservation(e, np.float64)),
    "TransformAction": ("Pendulum-v1", N, 200, 10, lambda V, e: V.TransformAction(e, lambda a: 0.5 * a)),
    "ClipAction": ("Pendulum-v1", N, 200, 10, lambda V, e: V.ClipAction(e)),
    "RescaleAction": ("Pendulum-v1", N, 200, 10, lambda V, e: V.RescaleAction(e, -1.0, 1.0)),
    "TransformReward": ("Pendulum-v1", N, 200, 10, lambda V, e: V.TransformReward(e, lambda r: 2 * r)),
    "ClipReward": ("Pendulum-v1", N, 200, 10, lambda V, e: V.ClipReward(e, -1.0, 0.0)),
    # the card's chain, at a step limit that ends every episode once
    "chain[HalfCheetah]": ("HalfCheetah-v5", N, 5, 8, lambda V, e: V.DictInfoToList(
        V.NormalizeReward(V.NormalizeObservation(V.ClipAction(V.RecordEpisodeStatistics(e)))))),
}


def episode_stats(env):
    """The ``RecordEpisodeStatistics`` layer of a stack of vector wrappers."""
    while type(env).__name__ != "RecordEpisodeStatistics":
        env = env.env
    return env


@pytest.mark.parametrize("name", sorted(TORCH_CASES))
def test_wrapper_over_torch_vector_env_holds_to_jax(name):
    env_id, n, limit, steps, wrap = TORCH_CASES[name]
    tap = Tap(torch_env(env_id, n, limit))
    port = wrap(TV, tap)
    actions = wide_actions(tap.single_action_space, n, steps)
    got = trajectory(port, actions)
    ref = wrap(JV, Replay(tap))
    assert type(port).__name__ == type(ref).__name__
    for attr in ("single_observation_space", "single_action_space"):
        assert_same_space(getattr(port, attr), getattr(ref, attr), attr)
    want = trajectory(ref, actions)
    for k, (a, b) in enumerate(zip(got, want)):
        assert_like_jax(without_times(a), without_times(b), f"{name} call {k}")
    if name.startswith(("RecordEpisodeStatistics", "chain")):
        assert episode_stats(port).episode_count == episode_stats(ref).episode_count > 0
    if name == "chain[HalfCheetah]":
        assert all(info["episode"]["l"] == limit for info in got[limit][4])


@pytest.mark.parametrize("name", ["FlattenObservation", "DtypeObservation"])
def test_unchanged_space_over_a_torch_vector_env_raises_type_error_as_jax(name):
    wrap = {"FlattenObservation": lambda V, e: V.FlattenObservation(e),
            "DtypeObservation": lambda V, e: V.DtypeObservation(e, np.float32)}[name]
    env = torch_env("Pendulum-v1", N, 200)
    wrapped = wrap(TV, env)
    assert wrapped.same_out
    with pytest.raises(TypeError, match="'out' must be an array"):
        wrapped.reset(seed=0)
    fresh = torch_env("Pendulum-v1", N, 200).reset(seed=0)[0]
    assert torch.equal(env._last_obs, fresh)
    with pytest.raises(TypeError, match="'out' must be an array"):
        wrapped.step(np.zeros((N, 1), np.float32))
    # JAX's wrapper raises the same error over device arrays
    with pytest.raises(TypeError, match="'out' must be an array"):
        wrap(JV, Replay(Tap(env))).observations(jnp.zeros((N, 3), jnp.float32))


@pytest.mark.parametrize("name", JV.__all__)
def test_vector_name_comes_from_the_module_of_the_same_name(name):
    got, want = getattr(TV, name), getattr(JV, name)
    assert got.__module__ == want.__module__.replace("gymnasium_tpu.", "gymnasium_tpu_torch.", 1)
    assert got.__name__ == want.__name__


def test_vector_catalog_lists_jax_names():
    assert TV.__all__ == JV.__all__
