"""The port's PPO train step over a sharded state on gloo ranks of the CPU,
against its unsharded step and the JAX package's ``shard_ppo_state`` step
on the virtual CPU devices of ``tests/conftest.py``.

A float32 CartPole step with NormalizeObservation, NormalizeReward and
EpisodeStatistics, the case of ``tests/test_torch_ppo.py`` (16 envs, 16
steps, every reset one fixed numpy batch): both sides start from the JAX
weights and wrapper states and take the JAX trainer's draws. A group of 2
ranks and one of 4 (processes importing only the port) start while JAX
steps, take its inputs on their inboxes, and step over a ``(dp, tp)`` mesh
and a ``(hosts, chips)`` one. Their parameters, metrics and observations
agree with both within 1e-5, every rank applies the same update, and the
step's collectives (``torch.profiler``'s gloo events and the port's own
count by group size) are as many at 2 ranks as at 4 and span all four
ranks of the two-level mesh, as ``tests/test_sharding.py`` holds the JAX
scaling proxy's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from gymnasium_tpu import parallel as jpar
from gymnasium_tpu.envs.phys2d.cartpole import CartPoleFunctional as JaxCartPole
from gymnasium_tpu.train import ppo as jppo
from gymnasium_tpu.wrappers import func as jfw
from gymnasium_tpu_torch.parallel import launch
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.train.policy import ppo_params_from_jax
from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward
from tests import torch_parallel_scenarios as sc
from tests.test_torch_parallel import GROUP_TIMEOUT_S, GROUPS
from tests.test_torch_ppo import jax_keys

# float32 parameters after one step: sums in another order (tests/test_torch_ppo.py)
PPO_TOL = 1e-5


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


class _JaxFixedReset(JaxCartPole):
    def initial_batched(self, rng, n, params=None):
        return jnp.asarray(sc.FIXED_RESET[:n])


def jax_ppo() -> dict:
    """JAX's sharded PPO step over 4 devices, and its weights, wrapper states
    and draws for the ports' steps."""
    jcfg = jppo.PPOConfig(**sc.PPO_CONFIG, compute_dtype=jnp.float32)
    jwrappers = (jfw.NormalizeObservation(), jfw.NormalizeReward(), jfw.EpisodeStatistics())
    jenv = _JaxFixedReset()
    jstate, env_params, tx = jppo.init_ppo(jenv, jcfg, jax.random.PRNGKey(0), wrappers=jwrappers)
    act_keys, perms = jax_keys(jstate, sc.PPO_CONFIG)
    noise = np.stack([np.asarray(jax.random.gumbel(k, (sc.PPO_ENVS, 2))) for k in act_keys])
    mesh = jpar.make_mesh(jax.devices()[:4])
    step = jax.jit(jppo.make_train_step(jenv, jcfg, env_params, tx, wrappers=jwrappers))
    jnew, jmetrics = step(jpar.shard_ppo_state(jstate, mesh))
    inputs = {"params": _host(jstate.params), "wrappers": _host(jstate.env_carry.wrappers),
              "noise": noise, "perms": np.asarray(perms)}
    policy = ppo_params_from_jax(_host(jnew.params), torch.float32)
    return {"inputs": inputs, "metrics": {k: float(v) for k, v in jmetrics.items()},
            "params": {name: p.detach().numpy() for name, p in policy.named_parameters()},
            "obs": np.asarray(jnew.obs)}




@pytest.fixture(scope="module")
def groups():
    """Each group's per-rank results, and JAX's step."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    ctx = mp.get_context("spawn")
    inboxes = {w: [ctx.Queue() for _ in range(w)] for w in GROUPS}
    started = {w: launch.start(sc.run_ppo, w, inboxes[w], device="cpu", timeout=GROUP_TIMEOUT_S) for w in GROUPS}
    try:
        jax_step = jax_ppo()  # while the ranks start
        for boxes in inboxes.values():
            for box in boxes:
                box.put(jax_step["inputs"])
        results = {w: group.join() for w, group in started.items()}
    finally:
        for group in started.values():
            group.kill()
        torch.set_num_threads(threads)
    return results, jax_step


@pytest.fixture(scope="module")
def port_ppo(groups):
    """The port's unsharded step from the same weights, wrapper states and draws."""
    inputs = groups[1]["inputs"]
    wrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    tcfg, state, params = sc.ppo_state(inputs, wrappers)
    draws = ppo.PPODraws(torch.from_numpy(inputs["noise"]), torch.from_numpy(inputs["perms"]).long())
    new, metrics = ppo.make_train_step(sc.FixedCartPole(), tcfg, params, wrappers)(state, draws=draws)
    return sc.ppo_result(new, metrics)


@pytest.mark.parametrize("world", GROUPS)
@pytest.mark.parametrize("level", ["ppo", "ppo_two_level"])
def test_sharded_ppo_step_matches_unsharded_and_jax(groups, port_ppo, world, level):
    jax_step = groups[1]
    ranks = groups[0][world]
    assert port_ppo["metrics"]["episodes_finished"] > 0, "no episode ended: the autoreset is not compared"
    for rank, got in enumerate(ranks):
        got = got[level]
        for name, value in got["params"].items():
            np.testing.assert_allclose(value, port_ppo["params"][name], rtol=PPO_TOL, atol=PPO_TOL, err_msg=name)
            np.testing.assert_allclose(value, jax_step["params"][name], rtol=PPO_TOL, atol=PPO_TOL, err_msg=name)
            # every rank applies the same update
            np.testing.assert_array_equal(value, ranks[0][level]["params"][name])
        for key in ("loss", "reward_per_step", "mean_value"):
            np.testing.assert_allclose(got["metrics"][key], port_ppo["metrics"][key], rtol=PPO_TOL, atol=PPO_TOL)
            np.testing.assert_allclose(got["metrics"][key], jax_step["metrics"][key], rtol=PPO_TOL, atol=PPO_TOL)
        assert got["metrics"]["episodes_finished"] == port_ppo["metrics"]["episodes_finished"] \
            == jax_step["metrics"]["episodes_finished"]
        per = sc.PPO_ENVS // world
        np.testing.assert_allclose(got["obs"], port_ppo["obs"][rank * per:(rank + 1) * per], rtol=PPO_TOL, atol=PPO_TOL)


def _total(counts: dict) -> int:
    return sum(counts.values())


def test_ppo_step_collectives_as_the_scaling_proxy_holds_them(groups):
    results = groups[0]
    for world, ranks in results.items():
        for got in ranks:
            for level in ("ppo", "ppo_two_level"):
                step = got[level]
                # every collective the profiler saw is one the port counted
                assert _total(step["gloo_events"]) == _total(step["recorded"]) > 0
                assert set(step["gloo_events"]) == {"gloo:all_reduce", "gloo:all_gather"}
    # the PPO step makes as many collectives at 2 ranks as at 4: a gather
    # of the moments for each statistics update (2 a step) and for the
    # advantages, an all-reduce of the gradient a minibatch and of the metrics
    steps, minibatches = sc.PPO_CONFIG["rollout_steps"], sc.PPO_CONFIG["update_epochs"] * sc.PPO_CONFIG[
        "num_minibatches"]
    for world in GROUPS:
        for r in results[world]:
            assert r["ppo"]["recorded"] == {f"all_gather/{world}": 2 * steps + 1,
                                            f"all_reduce/{world}": minibatches + 1}
    # on the (2, 2) two-level mesh the learner's collectives span all four ranks
    assert set(results[4][0]["ppo_two_level"]["recorded"]) == {"all_reduce/4", "all_gather/4"}


