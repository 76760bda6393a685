"""The port's tabular envs (FrozenLake, Taxi, CliffWalking) against the JAX package's.

- The dense model tables equal JAX's ``build_*_model`` outputs byte for byte,
  dtypes included.
- The hooks on every ``(s, a)`` of FrozenLake8x8 (slippery) and Taxi (dry
  and rainy): JAX's ``transition`` vmapped over a batch of keys, against the
  port's ``transition_values`` fed the Gumbel draws that
  ``jax.random.categorical`` adds for those keys (recomputed outside
  ``jit``). States, rewards, flags and observations are identical.
- ``initial`` the same way: JAX's vmapped ``initial`` against the port's
  ``reset_values`` of the same Gumbel draws over the states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.tabular.cliffwalking import CliffWalkingFunctional as JaxCliffWalking
from gymnasium_tpu.envs.tabular.frozen_lake import FrozenLake8x8Functional as JaxFrozenLake8x8
from gymnasium_tpu.envs.tabular.frozen_lake import FrozenLakeFunctional as JaxFrozenLake
from gymnasium_tpu.envs.tabular.taxi import TaxiFunctional as JaxTaxi
from gymnasium_tpu.envs.toy_text import cliffwalking as jax_cliff
from gymnasium_tpu.envs.toy_text import frozen_lake as jax_lake
from gymnasium_tpu.envs.toy_text import taxi as jax_taxi
from gymnasium_tpu_torch.envs import toy_text as port_text
from gymnasium_tpu_torch.envs.tabular import (
    CliffWalkingFunctional,
    FrozenLake8x8Functional,
    FrozenLakeFunctional,
    TaxiFunctional,
)

CUSTOM_DESC = ["SFHF", "FFFH", "HFFF", "FHFG", "FFFF"]


def jax_gumbels(keys, k: int) -> np.ndarray:
    """The Gumbel draws ``jax.random.categorical`` adds to ``k`` logits, for
    each key of ``keys`` (as ``vmap`` hands one key to each lane)."""
    return np.array(jax.vmap(lambda key: jax.random.gumbel(key, (k,)))(keys))


def lane_keys(seed: int, n: int):
    return jax.random.split(jax.random.PRNGKey(seed), n)


MODELS = {
    "frozen_lake_4x4": lambda m: m.build_frozen_lake_model(np.asarray(m.MAPS["4x4"], dtype="c")),
    "frozen_lake_4x4_dry": lambda m: m.build_frozen_lake_model(np.asarray(m.MAPS["4x4"], dtype="c"), False),
    "frozen_lake_8x8": lambda m: m.build_frozen_lake_model(np.asarray(m.MAPS["8x8"], dtype="c")),
    "frozen_lake_8x8_dry": lambda m: m.build_frozen_lake_model(np.asarray(m.MAPS["8x8"], dtype="c"), False),
    "frozen_lake_custom": lambda m: m.build_frozen_lake_model(
        np.asarray(CUSTOM_DESC, dtype="c"), True, 0.6, (5, -2, 0.5)),
    "taxi": lambda m: m.build_taxi_model(False),
    "taxi_rainy": lambda m: m.build_taxi_model(True),
    "cliffwalking": lambda m: m.build_cliffwalking_model(False),
    "cliffwalking_slippery": lambda m: m.build_cliffwalking_model(True),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_tables_equal_jax_byte_for_byte(name):
    jax_module = {"f": jax_lake, "t": jax_taxi, "c": jax_cliff}[name[0]]
    got, want = MODELS[name](port_text), MODELS[name](jax_module)
    assert got._fields == want._fields
    for field, a, b in zip(got._fields, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field


def test_taxi_encode_decode_and_constants_match_jax():
    assert port_text.MAP == jax_taxi.MAP and port_text.LOCS == jax_taxi.LOCS
    assert port_text.MAPS == jax_lake.MAPS
    for i in range(500):
        assert port_text.decode(i) == jax_taxi.decode(i)
        assert port_text.encode(*port_text.decode(i)) == i


ENVS = {
    "frozen_lake_8x8": (FrozenLake8x8Functional, JaxFrozenLake8x8, {}),
    "taxi": (TaxiFunctional, JaxTaxi, {}),
    "taxi_rainy": (TaxiFunctional, JaxTaxi, {"is_rainy": True, "fickle_passenger": True}),
    "frozen_lake_custom": (FrozenLakeFunctional, JaxFrozenLake,
                           {"desc": CUSTOM_DESC, "success_rate": 0.6, "reward_schedule": (5, -2, 0.5)}),
    "cliffwalking_slippery": (CliffWalkingFunctional, JaxCliffWalking, {"is_slippery": True}),
}


def _every_pair(env):
    s_count, a_count = env.model.num_states, env.model.num_actions
    s = np.repeat(np.arange(s_count, dtype=np.int32), a_count)
    a = np.tile(np.arange(a_count, dtype=np.int32), s_count)
    return s, a


@pytest.mark.parametrize("name", sorted(ENVS))
def test_hooks_on_every_state_and_action_are_identical_to_jax(name):
    port_cls, jax_cls, options = ENVS[name]
    penv, jenv = port_cls(dict(options)), jax_cls(dict(options))
    assert penv._deterministic == jenv._deterministic
    s, a = _every_pair(penv)
    rng = np.random.default_rng(0)
    state = {"s": s, "r": rng.uniform(-1, 1, s.shape).astype(np.float32), "t": rng.uniform(size=s.shape) < 0.5}
    keys = lane_keys(1, s.shape[0])
    jnext = jax.jit(jax.vmap(jenv.transition, in_axes=(0, 0, 0, None)))(
        {k: jnp.asarray(v) for k, v in state.items()}, jnp.asarray(a), keys, None)
    g = None if penv._deterministic else torch.from_numpy(jax_gumbels(keys, penv.model.probs.shape[-1]))
    pstate = {k: torch.from_numpy(v) for k, v in state.items()}
    pnext = penv.transition_values(pstate, torch.from_numpy(a), g)
    for key in ("s", "r", "t"):
        got, want = pnext[key].numpy(), np.asarray(jnext[key])
        assert got.dtype == want.dtype, key
        np.testing.assert_array_equal(got, want, err_msg=key)
    # a stochastic model took more than one branch somewhere
    taken = pnext["s"].numpy() != penv.model.next_state[s, a, 0]
    assert taken.any() != penv._deterministic
    gen = torch.Generator()
    obs = penv.observation(pnext, gen)
    assert obs.dtype == torch.int32
    np.testing.assert_array_equal(obs.numpy(), np.asarray(jax.vmap(jenv.observation, in_axes=(0, None, None))(
        jnext, None, None)))
    np.testing.assert_array_equal(penv.reward(pstate, a, pnext, gen).numpy(), np.asarray(jnext["r"]))
    np.testing.assert_array_equal(penv.terminal(pnext, gen).numpy(), np.asarray(jnext["t"]))


@pytest.mark.parametrize("name", sorted(ENVS))
def test_initial_is_identical_to_jax_with_its_gumbels(name):
    port_cls, jax_cls, options = ENVS[name]
    penv, jenv = port_cls(dict(options)), jax_cls(dict(options))
    keys = lane_keys(2, 256)
    want = jax.vmap(jenv.initial, in_axes=(0, None))(keys, None)
    got = penv.reset_values(torch.from_numpy(jax_gumbels(keys, penv.model.num_states)))
    for key in ("s", "r", "t"):
        assert got[key].dtype == getattr(torch, str(np.asarray(want[key]).dtype)), key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    if name.startswith("taxi"):  # 300 starting states: the draw matters
        assert len(np.unique(got["s"].numpy())) > 100


def test_draws_come_from_the_generator_and_reset_picks_allowed_states():
    env = TaxiFunctional({"is_rainy": True})
    a = env.initial_batched(torch.Generator().manual_seed(0), 512)
    b = env.initial_batched(torch.Generator().manual_seed(0), 512)
    c = env.initial_batched(torch.Generator().manual_seed(1), 512)
    assert torch.equal(a["s"], b["s"]) and not torch.equal(a["s"], c["s"])
    assert (env.model.initial_probs[a["s"].numpy()] > 0).all()
    one = env.initial(torch.Generator().manual_seed(0))
    assert one["s"].shape == () and one["s"].dtype == torch.int32
