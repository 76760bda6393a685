"""The port's entry points (counterparts of ``__graft_entry__.py``).

:func:`entry` is one iteration of the PPO rollout body: the observation of
an auto-resetting batch of CartPole envs goes through the policy (hidden
(64, 64) in bf16), an action is sampled per env, and the batch steps.
:func:`dryrun_multichip` runs the sharded paths once on every rank of an
initialised process group.
"""

from __future__ import annotations

import torch

from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.functional import make_autoreset_step, make_initial_carry, vectorize_func_env
from gymnasium_tpu_torch.train.policy import MLP, categorical
from gymnasium_tpu_torch.utils.device import resolve_device

__all__ = ["dryrun_multichip", "entry"]

NUM_ENVS = 256
HIDDEN_SIZES = (64, 64)


def entry(device: str | torch.device | None = None):
    """Return ``(forward_step, example_args)`` on ``device`` (CUDA by default).

    ``forward_step(policy, carry, rng)`` returns ``(carry, obs, reward,
    logits, actions)``: the JAX step's ``(carry, obs, reward)`` plus the
    policy's float32 logits and the sampled actions. ``example_args`` is
    ``(policy, carry, rng)`` for 256 envs, with weights and the initial
    batch drawn from fixed seeds.
    """
    device = resolve_device(device)
    func_env = CartPoleFunctional()
    env_params = func_env.get_default_params()
    obs_dim = func_env.observation_space.shape[0]
    act_dim = int(func_env.action_space.n)

    # weights are drawn on the CPU so a seed gives the same policy on any device
    policy = MLP(
        (obs_dim, *HIDDEN_SIZES, act_dim),
        compute_dtype=torch.bfloat16,
        generator=torch.Generator().manual_seed(0),
    ).to(device)

    batched = vectorize_func_env(func_env, NUM_ENVS)
    env_step = make_autoreset_step(batched, env_params, time_limit=500)
    carry, _ = make_initial_carry(
        batched, torch.Generator(device=device).manual_seed(0), env_params
    )

    @torch.no_grad()  # a rollout step: nothing here is differentiated
    def forward_step(policy, carry, rng):
        obs = batched.observation(carry.state, rng, env_params)
        logits = policy(obs)
        actions = categorical(rng, logits)
        carry, ts = env_step(carry, actions)
        return carry, ts.obs, ts.reward, logits, actions

    example_args = (policy, carry, torch.Generator(device=device).manual_seed(1))
    return forward_step, example_args


def dryrun_multichip(n_ranks: int, device: str | torch.device | None = None) -> None:
    """Run the sharded paths once on tiny shapes over the ``n_ranks`` ranks
    of the initialised default process group, one device a rank (CUDA
    unless ``device="cpu"``, where the group is gloo's). Every rank calls it.

    Leg 1: the full PPO train step with observation and return normalisation
    and episode statistics over a ``(dp, tp)`` mesh, the env batch
    dp-sharded, the learner replicated. Leg 2: a dp-sharded HalfCheetah
    ``TorchVectorEnv`` for 2 steps. Leg 3: a sharded Reacher env, whose step
    is the articulated kernel (its plain twin on the CPU) on each rank's
    rows, then a masked partial reset.
    """
    import numpy as np
    import torch.distributed as dist

    from gymnasium_tpu_torch.envs.mujoco.half_cheetah import HalfCheetahFunctional
    from gymnasium_tpu_torch.envs.mujoco.reacher import ReacherFunctional
    from gymnasium_tpu_torch.parallel.mesh import NamedSharding, make_mesh, shard_ppo_state
    from gymnasium_tpu_torch.train.ppo import PPOConfig, init_ppo, make_train_step
    from gymnasium_tpu_torch.vector.torch_vector_env import TorchVectorEnv
    from gymnasium_tpu_torch.wrappers.func import EpisodeStatistics, NormalizeObservation, NormalizeReward

    device = resolve_device(device)
    if not dist.is_initialized() or dist.get_world_size() != n_ranks:
        raise RuntimeError(f"dryrun_multichip({n_ranks}) needs an initialised process group of {n_ranks} ranks")
    rank = dist.get_rank()
    tp = 2 if n_ranks % 2 == 0 and n_ranks >= 4 else 1
    mesh = make_mesh(device.type, tp=tp)
    dp, tp = mesh.size(0), mesh.size(1)

    num_envs = 8 * n_ranks  # tiny but divisible by the dp axis
    config = PPOConfig(num_envs=num_envs, rollout_steps=8, hidden_sizes=(32, 32), num_minibatches=2,
                       update_epochs=1, max_episode_steps=32)
    wrappers = (NormalizeObservation(), NormalizeReward(), EpisodeStatistics())
    func_env = CartPoleFunctional()
    state, env_params = init_ppo(func_env, config, 0, wrappers, device)
    state = shard_ppo_state(state, mesh)
    state, metrics = make_train_step(func_env, config, env_params, wrappers)(state)
    # CartPole rewards are +1 scaled by a positive running std
    assert float(metrics["reward_per_step"]) > 0.0
    if rank == 0:
        print(f"[dryrun leg 1] CartPole PPO train step: mesh (dp={dp}, tp={tp}), num_envs={num_envs}, "
              f"wrappers=3, ok", flush=True)

    env = TorchVectorEnv(HalfCheetahFunctional(), num_envs=2 * dp, max_episode_steps=8, seed=0, device=device,
                         sharding=NamedSharding(mesh, ("dp",)))
    env.reset()
    for _ in range(2):
        obs, *_ = env.step(np.zeros((env.num_envs,) + env.single_action_space.shape, np.float32))
    assert bool(torch.isfinite(obs.to_local()).all())
    engine = "articulated kernel" if device.type == "cuda" else "articulated twin"
    if rank == 0:
        print(f"[dryrun leg 2] HalfCheetah-v5 dp-sharded TorchVectorEnv: mesh dp={dp}, num_envs={env.num_envs}, "
              f"{engine}, ok", flush=True)

    rmesh = make_mesh(device.type)
    n = 32 * rmesh.size(0)
    renv = TorchVectorEnv(ReacherFunctional(), num_envs=n, max_episode_steps=8, seed=0, device=device,
                          sharding=NamedSharding(rmesh, ("dp",)))
    renv.reset()
    robs, *_ = renv.step(np.zeros((n,) + renv.single_action_space.shape, np.float32))
    assert bool(torch.isfinite(robs.to_local()).all())
    mask = np.zeros(n, np.bool_)
    mask[::2] = True  # reset every other lane; the others keep their state
    q_before = renv.carry.state["qpos"].to_local().clone()
    mobs, _ = renv.reset(options={"reset_mask": mask})
    q_after = renv.carry.state["qpos"].to_local()
    keep = ~torch.as_tensor(mask.reshape(rmesh.size(0), -1)[rmesh.get_coordinate()[0]], device=device)
    assert bool(torch.isfinite(mobs.to_local()).all())
    assert torch.equal(q_before[keep], q_after[keep]), "unmasked lanes must keep their state across a partial reset"
    if rank == 0:
        print(f"[dryrun leg 3] Reacher {engine} on each rank's rows: mesh dp={rmesh.size(0)}, num_envs={n}, "
              f"step + masked partial reset ({int(mask.sum())} lanes), ok", flush=True)
