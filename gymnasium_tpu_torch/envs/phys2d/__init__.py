"""Classic 2-D physics envs as functional envs, and the named adapters of
CartPole and Pendulum (as the JAX package's ``envs/phys2d/__init__.py``
exports its ``*JaxEnv`` classes)."""

from gymnasium_tpu_torch.envs.phys2d.acrobot import AcrobotFunctional
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional, CartPoleTorchEnv, CartPoleTorchVectorEnv
from gymnasium_tpu_torch.envs.phys2d.mountain_car import ContinuousMountainCarFunctional, MountainCarFunctional
from gymnasium_tpu_torch.envs.phys2d.pendulum import PendulumFunctional, PendulumTorchEnv, PendulumTorchVectorEnv

__all__ = [
    "AcrobotFunctional",
    "CartPoleFunctional",
    "CartPoleTorchEnv",
    "CartPoleTorchVectorEnv",
    "ContinuousMountainCarFunctional",
    "MountainCarFunctional",
    "PendulumFunctional",
    "PendulumTorchEnv",
    "PendulumTorchVectorEnv",
]
