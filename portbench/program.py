"""The system under test, as a user drives it: the only module of the
benchmark that imports ``gymnasium_tpu_torch``.

It builds what a cell's traffic drives through the program's public entry
points (``make_vec`` in the ``torch`` mode and ``TorchVectorEnv.rollout``;
``init_ppo`` and ``make_train_step`` with the functional wrappers) and hands
back the program's own objects. Nothing here computes a result the
reference is judged by.
"""

from __future__ import annotations

import torch

import gymnasium_tpu_torch as gym
from gymnasium_tpu_torch.envs.registration import load_env_creator, spec
from gymnasium_tpu_torch.train import ppo
from gymnasium_tpu_torch.wrappers import func as func_wrappers


def vector_env(config: dict, seed: int, device: torch.device):
    """``make_vec(env_id, num_envs)`` in the ``torch`` mode, reset with ``seed``."""
    env = gym.make_vec(config["env_id"], num_envs=config["num_envs"], vectorization_mode="torch",
                       vector_kwargs={"device": device, "max_episode_steps": config["max_episode_steps"]})
    env.reset(seed=seed)
    return env


def func_env(config: dict):
    """The registered functional env of ``env_id``."""
    creator = spec(config["env_id"]).torch_entry_point
    return (creator if callable(creator) else load_env_creator(creator))(None)


def trainer(config: dict, traffic: dict, seed: int, device: torch.device):
    """``(state, train_step)`` of the PPO trainer at the traffic's settings."""
    env = func_env(config)
    settings = traffic["ppo"]
    ppo_config = ppo.PPOConfig(
        num_envs=config["num_envs"],
        rollout_steps=settings["rollout_steps"],
        hidden_sizes=tuple(settings["hidden_sizes"]),
        lr=settings["lr"],
        gamma=settings["gamma"],
        gae_lambda=settings["gae_lambda"],
        clip_eps=settings["clip_eps"],
        entropy_coef=settings["entropy_coef"],
        value_coef=settings["value_coef"],
        num_minibatches=settings["num_minibatches"],
        update_epochs=settings["update_epochs"],
        max_grad_norm=settings["max_grad_norm"],
        max_episode_steps=config["max_episode_steps"],
        compute_dtype=getattr(torch, settings["compute_dtype"]),
    )
    wrappers = tuple(getattr(func_wrappers, name)() for name in settings["wrappers"])
    state, params = ppo.init_ppo(env, ppo_config, seed, wrappers, device)
    return state, ppo.make_train_step(env, ppo_config, params, wrappers)
