"""Training components of the torch port: the policy network and PPO."""

from gymnasium_tpu_torch.train.policy import (
    MLP,
    ActorCritic,
    categorical,
    mlp_from_jax_params,
    ppo_params_from_jax,
    wrapper_states_from_jax,
)
from gymnasium_tpu_torch.train.ppo import PPOConfig, PPODraws, PPOState, init_ppo, make_train_step, train

__all__ = [
    "MLP",
    "ActorCritic",
    "PPOConfig",
    "PPODraws",
    "PPOState",
    "categorical",
    "init_ppo",
    "make_train_step",
    "mlp_from_jax_params",
    "ppo_params_from_jax",
    "train",
    "wrapper_states_from_jax",
]
