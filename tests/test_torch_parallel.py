"""The port's ``parallel/`` on gloo ranks of the CPU against the JAX
package's ``parallel/`` on the virtual CPU devices of ``tests/conftest.py``.

A module fixture spawns a group of 2 ranks and one of 4 (each rank a
process of its own, importing only the port) that run every scenario of
``tests/torch_parallel_scenarios.py::run`` once and return numpy results;
the JAX side runs here meanwhile. A rank that fails, dies or hangs fails the
fixture within its deadline, and no rank outlives it. Checked: the mesh
shapes; each rank's rows of ``shard_env_batch`` against JAX's addressable
shard of the same device index; ``gather_trajectory``; a sharded CartPole
rollout equal to the unsharded one in every bit across autoresets (as
``tests/test_sharding.py`` holds JAX's); sharded HalfCheetah against JAX's
sharded ``JaxVectorEnv`` within ``1e-5 * max |JAX| + 1e-6``; no collective
in a sharded env step and one all-gather a leaf in ``gather_trajectory``
(``torch.profiler``'s gloo events and the port's own count by group size),
as ``tests/test_sharding.py`` holds the scaling proxy's; equal shard
shapes; ``scaling_report`` and ``dryrun_multichip``; a sharded env on a
group made anew within one rank, whose statistics reduce over the new group. The PPO step is
``tests/test_torch_parallel_ppo.py``'s.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gymnasium_tpu import parallel as jpar
from gymnasium_tpu.envs.mujoco.half_cheetah import HalfCheetahFunctional as JaxHalfCheetah
from gymnasium_tpu.vector.jax_vector_env import JaxVectorEnv
from torch.distributed.tensor import Replicate, Shard

from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.parallel import launch
from tests import torch_parallel_scenarios as sc

GROUPS = (2, 4)
GROUP_TIMEOUT_S = 120


def within(got, want) -> bool:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))) <= 1e-5 * float(np.max(np.abs(want))) + 1e-6


@pytest.fixture(scope="module")
def started():
    """The two groups, started; none outlives the module."""
    started = {w: launch.start(sc.run, w, device="cpu", timeout=GROUP_TIMEOUT_S) for w in GROUPS}
    yield started
    for group in started.values():
        group.kill()


@pytest.fixture(scope="module")
def groups(started, jax_cheetah):
    """Each group's results, by rank (JAX's HalfCheetah runs while the ranks do)."""
    return {w: group.join() for w, group in started.items()}


@pytest.mark.parametrize("world", GROUPS)
def test_mesh_shapes_match_jax(groups, world):
    devices = jax.devices()[:world]
    for rank in groups[world]:
        got = rank["mesh"]
        assert got["dp"] == dict(jpar.make_mesh(devices).shape)
        assert got["two_level"] == dict(jpar.make_mesh_two_level(devices, hosts=2).shape)
        assert got["tp2"] == dict(jpar.make_mesh(devices, tp=2).shape)
        with pytest.raises(AssertionError) as jax_error:
            jpar.make_mesh(devices, tp=3)
        assert got["tp3_error"] == str(jax_error.value)


@pytest.mark.parametrize("world", GROUPS)
@pytest.mark.parametrize("level", ["dp", "two_level"])
def test_shard_env_batch_rows_are_jax_addressable_shards(groups, world, level):
    devices = jax.devices()[:world]
    if level == "dp":
        mesh, axis, key = jpar.make_mesh(devices), "dp", "placed"
    else:
        mesh, axis, key = jpar.make_mesh_two_level(devices, hosts=2), ("hosts", "chips"), "placed_two_level"
    placed = jpar.shard_env_batch(dict(sc.batch_tree(), rng=jax.random.PRNGKey(0)), mesh, axis=axis)
    ranks = groups[world]
    for rank, got in enumerate(ranks):
        got = got[key]
        for name, leaf in got["local"].items():
            (jax_shard,) = [s.data for s in placed[name].addressable_shards if s.device == devices[rank]]
            np.testing.assert_array_equal(leaf, np.asarray(jax_shard), err_msg=f"rank {rank} {name}")
            assert got["sharded"][name] == (not placed[name].sharding.is_fully_replicated), name
        # the generator, seeded differently on each rank, is the first rank's everywhere
        np.testing.assert_array_equal(got["rng_state"], ranks[0][key]["rng_state"])
    assert placed["rng"].sharding.is_fully_replicated


@pytest.mark.parametrize("world", GROUPS)
def test_sharded_cartpole_rollout_equals_unsharded_in_every_bit(groups, world):
    for rank, got in enumerate(groups[world]):
        rollouts = got["rollouts"]
        want = rollouts["unsharded"]
        assert want["reward"].shape == (sc.ROLLOUT_STEPS, sc.ROLLOUT_ENVS)
        assert (want["terminated"] | want["truncated"]).sum() > sc.ROLLOUT_ENVS, "too few autoresets"
        for key in want:
            np.testing.assert_array_equal(rollouts["sharded"][key], want[key], err_msg=key)
            np.testing.assert_array_equal(rollouts["assigned"][key], want[key], err_msg=key)
            per = sc.ROLLOUT_ENVS // world
            np.testing.assert_array_equal(rollouts["sharded_local"][key], want[key][:, rank * per:(rank + 1) * per])
        assert rollouts["gathered_replicated"]


@pytest.mark.parametrize("world", GROUPS)
def test_gather_trajectory_is_one_all_gather_of_the_whole_batch(groups, world):
    for got in groups[world]:
        gather = got["gather"]
        want = got["rollouts"]["unsharded"]
        for key in want:
            np.testing.assert_array_equal(gather["gathered"][key], want[key][: sc.GATHER_STEPS], err_msg=key)
        assert gather["spec_before"] == [str(Shard(1)), str(Replicate())] and gather["replicated_after"]
        assert gather["collectives"] == {f"all_gather/{world}": 4}  # one a leaf: obs, reward, two flags


@pytest.fixture(scope="module")
def jax_cheetah():
    """JAX's dp-sharded HalfCheetah over 4 devices, reset to the port's
    ``reset_values`` of the scenarios' draws and stepped with their actions."""
    u, z = sc.cheetah_draws()
    states = {k: v.numpy() for k, v in HalfCheetahFunctional().reset_values(torch.from_numpy(u),
                                                                             torch.from_numpy(z)).items()}

    class Injected(JaxHalfCheetah):
        def initial_batched(self, rng, n, params=None):
            return {k: jnp.asarray(v[:n]) for k, v in states.items()}

    devices = jax.devices()[:4]
    env = JaxVectorEnv(Injected(), num_envs=sc.CHEETAH_ENVS, max_episode_steps=1000, seed=0,
                       sharding=NamedSharding(jpar.make_mesh(devices), P("dp")))

    def host(x):
        """The whole array, and each device's shard where it is sharded (the
        step donates the carry, so it is read at once)."""
        shards = None
        if not x.sharding.is_fully_replicated:
            shards = [np.asarray(s.data) for d in devices for s in x.addressable_shards if s.device == d]
        return np.asarray(x), shards

    obs, _ = env.reset()
    steps = [{"obs": host(obs)}]
    for actions in sc.cheetah_actions():
        obs, reward, *_ = env.step(jnp.asarray(actions))
        steps.append({"obs": host(obs), "reward": host(reward), "qpos": host(env.carry.state["qpos"]),
                      "qvel": host(env.carry.state["qvel"])})
    return steps


@pytest.mark.parametrize("world", GROUPS)
def test_sharded_half_cheetah_matches_jax_sharded_vector_env(groups, jax_cheetah, world):
    ranks = groups[world]
    for s, jstep in enumerate(jax_cheetah):
        for key, (want, shards) in jstep.items():
            got = np.concatenate([rank["cheetah"]["steps"][s][key] for rank in ranks])
            assert within(got, want), f"step {s} {key}: {np.abs(got - want).max()}"
            if world == 4 and s > 0:
                assert shards is not None, f"JAX's {key} is not sharded"
                for r, rank in enumerate(ranks):
                    assert within(rank["cheetah"]["steps"][s][key], shards[r]), f"rank {r} step {s} {key}"


def test_sharded_env_step_makes_no_collective(groups):
    for ranks in groups.values():
        for got in ranks:
            assert got["env_step"]["gloo_events"] == {} and got["env_step"]["recorded"] == {}


def test_equal_shard_shapes_at_16_envs_a_rank(groups):
    shapes = {world: {r["env_step"]["shard_shape"] for r in ranks} for world, ranks in groups.items()}
    assert shapes == {2: {(sc.ENVS_A_RANK, 4)}, 4: {(sc.ENVS_A_RANK, 4)}}


@pytest.mark.slow
def test_equal_shard_shapes_at_8_ranks():
    shapes = launch.run_ranks(sc.shard_shapes, 8, device="cpu", timeout=GROUP_TIMEOUT_S)
    assert set(shapes) == {(sc.ENVS_A_RANK, 4)}


@pytest.mark.parametrize("world", GROUPS)
def test_sharded_env_on_a_group_made_anew_reduces_over_the_new_group(groups, world):
    for got in groups[world]:
        regroup = got["regroup"]
        assert regroup["equal_meshes"] and regroup["new_shard"]
        for key, want in regroup["unsharded"].items():
            np.testing.assert_array_equal(regroup["after"][key], regroup["before"][key], err_msg=key)
            assert within(regroup["after"][key].astype(np.float64), want.astype(np.float64)), key


@pytest.mark.parametrize("world", GROUPS)
def test_scaling_report_and_dryrun(groups, world):
    ranks = groups[world]
    reports = [r["scaling"] for r in ranks]
    assert set(reports[0]) == {"devices", "sharded_s", "single_device_s", "scaling_efficiency"}
    assert reports[0]["devices"] == world and all(report == reports[0] for report in reports)
    text = ranks[0]["dryrun"]
    for leg in (1, 2, 3):
        assert f"[dryrun leg {leg}]" in text and text.split(f"[dryrun leg {leg}]")[1].split("\n")[0].endswith("ok")
    tp = 2 if world >= 4 else 1
    assert f"mesh (dp={world // tp}, tp={tp})" in text
    assert all(r["dryrun"] == "" for r in ranks[1:])
