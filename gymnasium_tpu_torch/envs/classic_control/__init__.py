"""Classic-control host env classes behind ``make(id)`` (counterpart of the
JAX package's ``envs/classic_control``; reference
gymnasium/envs/classic_control/__init__.py). They run on the host in
numpy and take no device; ``make_vec(id)`` runs the same dynamics as
functional envs on the card (``envs/phys2d``)."""

from gymnasium_tpu_torch.envs.classic_control.acrobot import AcrobotEnv
from gymnasium_tpu_torch.envs.classic_control.cartpole import CartPoleEnv, CartPoleVectorEnv
from gymnasium_tpu_torch.envs.classic_control.continuous_mountain_car import (
    Continuous_MountainCarEnv,
)
from gymnasium_tpu_torch.envs.classic_control.mountain_car import MountainCarEnv
from gymnasium_tpu_torch.envs.classic_control.pendulum import PendulumEnv

__all__ = [
    "AcrobotEnv",
    "CartPoleEnv",
    "CartPoleVectorEnv",
    "Continuous_MountainCarEnv",
    "MountainCarEnv",
    "PendulumEnv",
]
