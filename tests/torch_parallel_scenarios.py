"""What each rank of a gloo group runs for ``tests/test_torch_parallel*.py``.

The ranks import only the port (and numpy), never JAX: the test process
compares what they return with the JAX package. :func:`run` runs every
scenario but PPO's once and returns numpy results; :func:`run_ppo`
(``tests/test_torch_parallel_ppo.py``) waits for its inputs (the JAX
trainer's weights, wrapper states and draws) on the rank's inbox, so the
ranks start while the test process computes them.
"""

from __future__ import annotations

import contextlib
import datetime
import io

import numpy as np
import torch
import torch.distributed as dist

from gymnasium_tpu_torch.envs.box2d.lunar_lander import LunarLanderFunctional
from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.parallel import shard as env_shard
from gymnasium_tpu_torch.parallel.mesh import (
    NamedSharding,
    gather_trajectory,
    make_mesh,
    make_mesh_two_level,
    scaling_report,
    shard_env_batch,
    shard_ppo_state,
)
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.train.policy import ppo_params_from_jax, wrapper_states_from_jax
from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv
from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward

ROLLOUT_ENVS, ROLLOUT_STEPS, ROLLOUT_LIMIT = 64, 100, 100
GATHER_STEPS = 16
REGROUP_STEPS = 16
ENVS_A_RANK = 16
CHEETAH_ENVS, CHEETAH_STEPS = 16, 8
LANDER_ENVS, LANDER_STEPS, LANDER_LIMIT = 16, 8, 3
# the PPO case of tests/test_torch_ppo.py, with the three wrappers
PPO_ENVS, PPO_STEPS, PPO_LIMIT = 16, 16, 10
PPO_CONFIG = dict(num_envs=PPO_ENVS, rollout_steps=PPO_STEPS, hidden_sizes=(32, 32), num_minibatches=2,
                  update_epochs=2, max_episode_steps=PPO_LIMIT)
FIXED_RESET = np.random.default_rng(0).uniform(-0.05, 0.05, size=(PPO_ENVS, 4)).astype(np.float32)


def batch_tree() -> dict:
    """A numpy env tree of 64 envs: per-env leaves and shared ones."""
    n = ROLLOUT_ENVS
    return {
        "state": np.arange(n * 4, dtype=np.float32).reshape(n, 4),
        "steps": np.arange(n, dtype=np.int32),
        "done": np.arange(n) % 3 == 0,
        "shared": np.array([1.5, -2.0, 3.25], np.float32),
        "scalar": np.float32(7.0),
    }


def cheetah_draws() -> tuple[np.ndarray, np.ndarray]:
    """The reset draws (u ~ U[0, 1) (N, nq), z ~ N(0, 1) (N, nv)) both sides map."""
    rng = np.random.default_rng(3)
    return (rng.uniform(0.0, 1.0, (CHEETAH_ENVS, 9)).astype(np.float32),
            rng.standard_normal((CHEETAH_ENVS, 9)).astype(np.float32))


def cheetah_actions() -> np.ndarray:
    return np.random.default_rng(4).uniform(-1.0, 1.0, (CHEETAH_STEPS, CHEETAH_ENVS, 6)).astype(np.float32)


class FixedCheetah(HalfCheetahFunctional):
    """HalfCheetah whose reset draws are :func:`cheetah_draws`."""

    def reset_draws(self, rng, n):
        u, z = cheetah_draws()
        return torch.from_numpy(u[:n]), torch.from_numpy(z[:n])


class FixedCartPole(CartPoleFunctional):
    """CartPole whose every reset is :data:`FIXED_RESET` (tests/test_torch_ppo.py's)."""

    def reset_draws(self, rng, n):
        return (torch.from_numpy(FIXED_RESET[:n]).to(rng.device),)

    def reset_values(self, u, params=None):
        return u


def _np(x):
    x = x.to_local() if hasattr(x, "to_local") else x
    return x.detach().cpu().numpy()


def mesh_shapes(world: int) -> dict:
    def shape(mesh):
        return dict(zip(mesh.mesh_dim_names, list(mesh.mesh.shape)))

    out = {"dp": shape(make_mesh("cpu")), "two_level": shape(make_mesh_two_level("cpu", hosts=2))}
    if world % 2 == 0:
        out["tp2"] = shape(make_mesh("cpu", tp=2))
    try:
        make_mesh("cpu", tp=3)
    except AssertionError as e:
        out["tp3_error"] = str(e)
    return out


def placed_tree(mesh, axis) -> dict:
    """:func:`batch_tree` with a generator seeded by the rank, placed over ``mesh``."""
    tree = dict(batch_tree(), rng=torch.Generator().manual_seed(100 + dist.get_rank()))
    placed = shard_env_batch(tree, mesh, axis=axis)
    return {
        "local": {k: _np(v) for k, v in placed.items() if k != "rng"},
        "sharded": {k: any(p.is_shard() for p in v.placements) for k, v in placed.items() if k != "rng"},
        "rng_state": placed["rng"].get_state().numpy(),
    }


def traj_numpy(traj) -> dict:
    return {k: _np(getattr(traj, k)) for k in ("obs", "reward", "terminated", "truncated")}


def cartpole_rollouts(mesh) -> dict:
    """The unsharded rollout, the one of an env built with ``sharding`` and
    the one of a sharded carry assigned to a plain env, gathered."""
    kw = dict(max_episode_steps=ROLLOUT_LIMIT, seed=0, device="cpu")
    plain = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, **kw)
    plain.reset()
    _, want = plain.rollout(ROLLOUT_STEPS)
    sharded = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, sharding=NamedSharding(mesh, ("dp",)), **kw)
    sharded.reset()
    assert not sharded.carry.state.placements[0].is_replicate()
    _, got = sharded.rollout(ROLLOUT_STEPS)
    assigned = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, **kw)
    assigned.reset()
    assigned.carry = shard_env_batch(assigned.carry, mesh)
    _, got_assigned = assigned.rollout(ROLLOUT_STEPS)
    return {
        "unsharded": traj_numpy(want),
        "sharded": traj_numpy(gather_trajectory(got, mesh)),
        "sharded_local": traj_numpy(got),
        "assigned": traj_numpy(gather_trajectory(got_assigned, mesh)),
        "gathered_replicated": all(p.is_replicate() for p in gather_trajectory(got, mesh).obs.placements),
    }


def gather_case(mesh) -> dict:
    env = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, max_episode_steps=ROLLOUT_LIMIT, seed=0, device="cpu")
    env.reset()
    env.carry = shard_env_batch(env.carry, mesh)
    _, traj = env.rollout(GATHER_STEPS)
    before = dict(env_shard.collectives)
    gathered = gather_trajectory(traj, mesh)
    return {"gathered": traj_numpy(gathered), "collectives": _since(before),
            "spec_before": [str(p) for p in traj.obs.placements],
            "replicated_after": all(p.is_replicate() for p in gathered.obs.placements)}


def _since(before: dict) -> dict:
    return {f"{op}/{size}": n - before.get((op, size), 0) for (op, size), n in env_shard.collectives.items()
            if n - before.get((op, size), 0)}


def _profiled(fn):
    """``fn()`` under ``torch.profiler``: its result, the gloo events by name,
    and the collectives the port recorded meanwhile."""
    before = dict(env_shard.collectives)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    events: dict = {}
    for e in prof.events():
        if e.name.startswith("gloo:"):
            events[e.name] = events.get(e.name, 0) + 1
    return out, events, _since(before)


def cheetah_case(mesh) -> dict:
    env = TorchVectorEnv(FixedCheetah(), CHEETAH_ENVS, max_episode_steps=1000, seed=0, device="cpu",
                         sharding=NamedSharding(mesh, ("dp",)))
    obs, _ = env.reset()
    steps = [{"obs": _np(obs)}]
    for actions in cheetah_actions():
        obs, reward, *_ = env.step(actions)
        steps.append({"obs": _np(obs), "reward": _np(reward), "qpos": _np(env.carry.state["qpos"]),
                      "qvel": _np(env.carry.state["qvel"])})
    return {"steps": steps}


def env_step_collectives(mesh) -> dict:
    env = TorchVectorEnv(CartPoleFunctional(), ENVS_A_RANK * mesh.size(), max_episode_steps=50, seed=0, device="cpu",
                         sharding=NamedSharding(mesh, ("dp",)))
    env.reset()
    _, events, recorded = _profiled(lambda: env.step(np.zeros(env.num_envs, np.int64)))
    return {"gloo_events": events, "recorded": recorded, "shard_shape": tuple(env.carry.state.to_local().shape)}


def ppo_state(inputs, wrappers):
    """The port's PPO state from the JAX trainer's weights, wrapper states and obs."""
    tcfg = ppo.PPOConfig(**PPO_CONFIG, compute_dtype=torch.float32)
    state, params = ppo.init_ppo(FixedCartPole(), tcfg, wrappers=wrappers, device="cpu")
    policy = ppo_params_from_jax(inputs["params"], torch.float32)
    state = state._replace(
        policy=policy,
        optimizer=torch.optim.Adam(policy.parameters(), lr=tcfg.lr),
        env_carry=state.env_carry._replace(wrappers=wrapper_states_from_jax(inputs["wrappers"])),
    )
    return tcfg, state, params


def ppo_result(state, metrics) -> dict:
    return {
        "params": {name: p.detach().numpy().copy() for name, p in state.policy.named_parameters()},
        "metrics": {k: float(v) for k, v in metrics.items()},
        "obs": _np(state.obs),
    }


def ppo_case(mesh, inputs, axis) -> dict:
    wrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    tcfg, state, params = ppo_state(inputs, wrappers)
    state = shard_ppo_state(state, mesh, axis=axis)
    draws = ppo.PPODraws(torch.from_numpy(inputs["noise"]), torch.from_numpy(inputs["perms"]).long())
    step = ppo.make_train_step(FixedCartPole(), tcfg, params, wrappers)
    (new, metrics), events, recorded = _profiled(lambda: step(state, draws=draws))
    return {**ppo_result(new, metrics), "gloo_events": events, "recorded": recorded}


def scaling_case(mesh) -> dict:
    env = TorchVectorEnv(CartPoleFunctional(), ENVS_A_RANK * mesh.size(), max_episode_steps=50, seed=0, device="cpu",
                         sharding=NamedSharding(mesh, ("dp",)))
    env.reset()
    carry = env.carry
    report = scaling_report(lambda c: env.rollout(4, carry=c), (carry,), mesh, iters=2)
    env.carry = carry
    return report


def dryrun(world: int) -> str:
    from gymnasium_tpu_torch.entry import dryrun_multichip

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(world, "cpu")
    return text.getvalue()


def _restart_group(rank: int, world: int) -> None:
    """Destroy the default group and start a new one over the same ranks,
    through a store on a port the OS gives the first rank."""
    store = dist.TCPStore("127.0.0.1", 0, world, is_master=True, wait_for_workers=False) if rank == 0 else None
    port = [store.port if store is not None else None]
    dist.broadcast_object_list(port, src=0)
    dist.barrier()
    dist.destroy_process_group()
    if store is None:
        store = dist.TCPStore("127.0.0.1", port[0], world, is_master=False)
    dist.init_process_group("gloo", store=store, rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))


def regroup_case(rank: int, world: int) -> dict:
    """A sharded CartPole env with NormalizeObservation (its statistics
    reduce over the env axis) on a ``(dp, tp=2)`` mesh; then the default
    group made anew, and the same on a new mesh of the same layout, which
    compares equal to the old one. The new env's shard must be the new
    mesh's, its group the new one; both rollouts, gathered, against the
    unsharded one."""
    kw = dict(max_episode_steps=ROLLOUT_LIMIT, seed=0, device="cpu", wrappers=(NormalizeObservation(),))

    def rollout(mesh):
        env = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, sharding=NamedSharding(mesh, ("dp",)), **kw)
        env.reset()
        _, traj = env.rollout(REGROUP_STEPS)
        return env._shard_of(env.carry), traj_numpy(gather_trajectory(traj, mesh))

    plain = TorchVectorEnv(CartPoleFunctional(), ROLLOUT_ENVS, **kw)
    plain.reset()
    _, want = plain.rollout(REGROUP_STEPS)
    old_mesh = make_mesh("cpu", tp=2)
    _, before = rollout(old_mesh)
    _restart_group(rank, world)
    mesh = make_mesh("cpu", tp=2)
    shard, after = rollout(mesh)
    return {"unsharded": traj_numpy(want), "before": before, "after": after, "equal_meshes": mesh == old_mesh,
            "new_shard": shard.mesh is mesh and shard.group is mesh.get_group(0)}


def lander_rollouts(rank: int, world: int) -> dict:
    """LunarLander's ``rollout`` from one seed: sharded over the dp mesh
    (this rank's rows, through the one-launch autoreset), unsharded, and
    unsharded with ``autoreset_transition`` hidden (a transition and a
    reset a step); trajectories and final states as numpy."""
    mesh = make_mesh("cpu")
    hidden = LunarLanderFunctional()
    hidden.autoreset_transition = None
    kw = dict(max_episode_steps=LANDER_LIMIT, seed=0, device="cpu")
    out = {}
    for label, func, sharding in (("sharded", LunarLanderFunctional(), NamedSharding(mesh, ("dp",))),
                                  ("unsharded", LunarLanderFunctional(), None), ("hidden", hidden, None)):
        env = TorchVectorEnv(func, LANDER_ENVS, sharding=sharding, **kw)
        env.reset()
        carry, traj = env.rollout(LANDER_STEPS)
        shard = env._shard_of(carry)
        out[label] = {"traj": traj_numpy(traj), "state": {k: _np(v) for k, v in carry.state.items()},
                      "shard": None if shard is None else shard.index}
    return out


def run(rank: int, world: int) -> dict:
    """Every scenario but PPO's on this rank of a ``world``-rank gloo group."""
    mesh = make_mesh("cpu")
    two_level = make_mesh_two_level("cpu", hosts=2)
    return {
        "mesh": mesh_shapes(world),
        "placed": placed_tree(mesh, "dp"),
        "placed_two_level": placed_tree(two_level, ("hosts", "chips")),
        "rollouts": cartpole_rollouts(mesh),
        "gather": gather_case(mesh),
        "cheetah": cheetah_case(mesh),
        "env_step": env_step_collectives(mesh),
        "scaling": scaling_case(mesh),
        "dryrun": dryrun(world),
        "regroup": regroup_case(rank, world),  # last: it ends the group the others ran in
    }


def run_ppo(rank: int, world: int, inboxes) -> dict:
    """The PPO step over the dp mesh and the two-level one, from the inputs
    that arrive on this rank's inbox."""
    inputs = inboxes[rank].get(timeout=120)
    return {"ppo": ppo_case(make_mesh("cpu"), inputs, "dp"),
            "ppo_two_level": ppo_case(make_mesh_two_level("cpu", hosts=2), inputs, ("hosts", "chips"))}


def shard_shapes(rank: int, world: int) -> tuple:
    """The local carry's shape with :data:`ENVS_A_RANK` envs a rank, after a step."""
    return env_step_collectives(make_mesh("cpu"))["shard_shape"]


def cuda_cheetah(rank: int, world: int) -> dict:
    """Sharded HalfCheetah on this rank's card against the unsharded env from
    the same seed: whether every step's outputs and state are the same bits."""
    from gymnasium_tpu_torch.ops import articulated_step as art
    from gymnasium_tpu_torch.parallel.mesh import local

    dev = torch.device("cuda", torch.cuda.current_device())
    mesh = make_mesh()
    kw = dict(max_episode_steps=8, seed=0, device=dev)
    plain = TorchVectorEnv(HalfCheetahFunctional(), 256 * world, **kw)
    sharded = TorchVectorEnv(HalfCheetahFunctional(), 256 * world, sharding=NamedSharding(mesh, ("dp",)), **kw)
    plain.reset()
    sharded.reset()
    shard = sharded._shard_of(sharded.carry)
    actions = torch.rand((12, 256 * world, 6), generator=torch.Generator(device=dev).manual_seed(1), device=dev) * 2 - 1
    launches = sum(art.launches.values())
    same = []
    for a in actions:
        want = plain.step(a)
        got = sharded.step(a)
        same.append(all(torch.equal(local(g), shard.take(w)) for g, w in zip(got[:4], want[:4])))
        same.append(torch.equal(local(sharded.carry.state["qvel"]), shard.take(plain.carry.state["qvel"])))
    return {"same": same, "launches": sum(art.launches.values()) - launches}


def cuda_dryrun(rank: int, world: int) -> str:
    from gymnasium_tpu_torch.entry import dryrun_multichip

    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dryrun_multichip(world)
    return text.getvalue()
