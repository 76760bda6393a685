"""The port's forward step on the flagship path (counterpart of ``__graft_entry__.entry``).

One iteration of the PPO rollout body: the observation of an auto-resetting
batch of CartPole envs goes through the policy (hidden (64, 64) in bf16),
an action is sampled per env, and the batch steps.
"""

from __future__ import annotations

import torch

from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.functional import make_autoreset_step, make_initial_carry, vectorize_func_env
from gymnasium_tpu_torch.train.policy import MLP, categorical
from gymnasium_tpu_torch.utils.device import resolve_device

__all__ = ["entry"]

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
