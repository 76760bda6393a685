"""``FunctionalTorchEnv`` (the port's single-env adapter) against the JAX
package's ``FunctionalJaxEnv``.

CartPole's dynamics draw nothing, so both step from JAX's reset state with
the same actions. The slippery tabular envs take JAX's Gumbel draws, recomputed
from the keys ``FunctionalJaxEnv`` splits (three ways a reset, five a step)
and fed to the port's ``reset_draws``/``transition_draws``: identical.
"""

import pickle
import warnings

import jax
import numpy as np
import pytest
import torch

import gymnasium_tpu as jgym
import gymnasium_tpu_torch as tgym
from gymnasium_tpu.envs.functional_jax_env import FunctionalJaxEnv
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.envs.tabular.cliffwalking import CliffWalkingFunctional as JaxCliffWalking
from gymnasium_tpu.envs.tabular.frozen_lake import FrozenLakeFunctional as JaxFrozenLake
from gymnasium_tpu_torch.envs.functional_torch_env import FunctionalTorchEnv, FunctionalTorchVectorEnv
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.envs.tabular.cliffwalking import CliffWalkingFunctional
from gymnasium_tpu_torch.envs.tabular.frozen_lake import FrozenLakeFunctional
from gymnasium_tpu_torch.vector import TorchVectorEnv

OBS_ATOL = 2e-5
STEPS = 50


def cartpole_pair():
    jenv = FunctionalJaxEnv(JaxCartPole())
    tenv = FunctionalTorchEnv(CartPoleFunctional(), device="cpu")
    jobs, _ = jenv.reset(seed=0)
    tenv.reset(seed=0)
    tenv.state = torch.from_numpy(np.asarray(jenv.state).copy())
    return jenv, tenv, np.asarray(jobs)


def test_cartpole_steps_match_jax_from_its_reset_state():
    jenv, tenv, _ = cartpole_pair()
    actions = np.random.default_rng(0).integers(0, 2, STEPS)
    ended = False
    for action in actions:
        jobs, jrew, jterm, jtrunc, jinfo = jenv.step(int(action))
        tobs, trew, tterm, ttrunc, tinfo = tenv.step(int(action))
        assert isinstance(tobs, torch.Tensor) and tobs.shape == (4,) and tobs.dtype == torch.float32
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
        assert type(trew) is float and trew == jrew
        assert tterm is jterm and ttrunc is jtrunc is False
        assert tinfo == jinfo == {}
        ended |= tterm
    assert ended  # 50 random steps end a CartPole episode: the flag is tested both ways
    assert tenv.state.shape == np.asarray(jenv.state).shape


@pytest.mark.parametrize("name", ["frozen_lake", "cliffwalking_slippery"])
def test_slippery_tabular_env_is_identical_to_jax_with_its_draws(name):
    options = {"frozen_lake": {}, "cliffwalking_slippery": {"is_slippery": True}}[name]
    port_cls, jax_cls = {"frozen_lake": (FrozenLakeFunctional, JaxFrozenLake),
                         "cliffwalking_slippery": (CliffWalkingFunctional, JaxCliffWalking)}[name]
    func = port_cls(dict(options))
    assert not func._deterministic
    pending = []
    func.reset_draws = lambda rng, n: (pending.pop(0),)
    func.transition_draws = lambda rng, n: (pending.pop(0),)
    jenv, tenv = FunctionalJaxEnv(jax_cls(dict(options))), FunctionalTorchEnv(func, device="cpu")

    def gumbels(key, k):
        return torch.from_numpy(np.asarray(jax.random.gumbel(key, (k,))))[None]

    pending.append(gumbels(jax.random.split(jax.random.PRNGKey(7), 3)[1], func.model.num_states))
    tobs, _ = tenv.reset(seed=7)
    jobs, _ = jenv.reset(seed=7)
    assert type(tobs) is np.int64 and tobs == jobs
    actions = np.random.default_rng(1).integers(0, func.model.num_actions, 60)
    slipped = 0
    for action in actions:
        pending.append(gumbels(jax.random.split(jenv.rng, 5)[1], func.model.probs.shape[-1]))
        before = int(tenv.state["s"])
        tobs, trew, tterm, _, _ = tenv.step(int(action))
        jobs, jrew, jterm, _, _ = jenv.step(int(action))
        assert type(tobs) is np.int64 and tobs == np.int64(jobs)
        assert trew == jrew and tterm is jterm
        slipped += int(tobs != func.model.next_state[before, action, 0])
        if tterm:
            pending.append(gumbels(jax.random.split(jax.random.PRNGKey(int(action)), 3)[1], func.model.num_states))
            tenv.reset(seed=int(action))
            jenv.reset(seed=int(action))
    assert slipped > 0 and not pending


def test_pickle_round_trip_keeps_state_generator_and_device():
    env = FunctionalTorchEnv(FrozenLakeFunctional(), device="cpu")
    env.reset(seed=3)
    for action in (1, 2, 2):
        env.step(action)
    clone = pickle.loads(pickle.dumps(env))
    assert clone.device == env.device and torch.equal(clone.state["s"], env.state["s"])
    assert torch.equal(clone.rng.get_state(), env.rng.get_state())
    for action in (1, 2, 1, 0, 2, 2, 1, 1):
        assert env.step(action)[:3] == clone.step(action)[:3]


def test_discrete_observations_are_np_int64_and_boxes_tensors():
    env = FunctionalTorchEnv(CliffWalkingFunctional(), device="cpu")
    obs, info = env.reset(seed=0)
    assert type(obs) is np.int64 and obs == 36 and info == {}
    obs, reward, term, trunc, _ = env.step(1)
    assert type(obs) is np.int64 and (obs, reward, term, trunc) == (36, -100.0, False, False)
    assert env.observation_space.contains(obs)
    box_env = FunctionalTorchEnv(CartPoleFunctional(), device="cpu")
    obs, _ = box_env.reset(seed=0)
    assert isinstance(obs, torch.Tensor) and box_env.observation_space.contains(obs)


def test_render_raises_as_the_functional_has_no_renderer():
    # without a render mode the adapter draws nothing; FrozenLake's functional
    # has no render hooks (CartPole's draw frames, tests/test_torch_functional_render.py)
    env = FunctionalTorchEnv(CartPoleFunctional(), device="cpu")
    env.reset(seed=0)
    with pytest.raises(NotImplementedError):
        env.render()
    with pytest.raises(NotImplementedError):
        FunctionalTorchEnv(FrozenLakeFunctional(), render_mode="rgb_array", device="cpu")
    env.close()


def test_reset_seed_reseeds_the_generator():
    env = FunctionalTorchEnv(CartPoleFunctional(), device="cpu")
    first, _ = env.reset(seed=11)
    other, _ = env.reset(seed=12)
    again, _ = env.reset(seed=11)
    assert torch.equal(first, again) and not torch.equal(first, other)
    assert env.np_random_seed == 11


def wrapper_chain(env) -> list[str]:
    names = []
    while hasattr(env, "env"):
        names.append(type(env).__name__)
        env = env.env
    return names


def test_make_wraps_the_adapter_and_matches_jax_make():
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # the checker accepts the port's tensors
        tenv = tgym.make("phys2d/CartPole-v1", device="cpu")
        jenv = jgym.make("phys2d/CartPole-v1")
        assert wrapper_chain(tenv) == ["TimeLimit", "OrderEnforcing", "PassiveEnvChecker"] == wrapper_chain(jenv)
        assert isinstance(tenv.unwrapped, FunctionalTorchEnv)
        assert tenv.unwrapped.device == torch.device("cpu")
        assert "device" not in vars(tenv.unwrapped.func_env)
        jenv.reset(seed=0)
        tenv.reset(seed=0)
        tenv.unwrapped.state = torch.from_numpy(np.asarray(jenv.unwrapped.state).copy())
        steps = 0
        while True:
            action = steps % 2
            tobs, trew, tterm, ttrunc, _ = tenv.step(action)
            jobs, jrew, jterm, jtrunc, _ = jenv.step(action)
            np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), atol=OBS_ATOL, rtol=0)
            assert (trew, tterm, ttrunc) == (jrew, jterm, jtrunc)
            steps += 1
            if tterm or ttrunc:
                break
    assert tenv.spec.id == "phys2d/CartPole-v1" and tenv.spec.max_episode_steps == 500


def test_vector_adapter_is_the_torch_vector_env():
    assert issubclass(FunctionalTorchVectorEnv, TorchVectorEnv)
    env = tgym.make_vec("phys2d/CartPole-v1", 4, vectorization_mode="vector_entry_point", device="cpu")
    assert isinstance(env, TorchVectorEnv) and env.time_limit == 500 and env.device == torch.device("cpu")


def test_entry_points_refuse_a_missing_card():
    if torch.cuda.is_available():
        assert FunctionalTorchEnv(CartPoleFunctional()).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgym.make("phys2d/CartPole-v1")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgym.make_vec("CartPole-v1", 4)
