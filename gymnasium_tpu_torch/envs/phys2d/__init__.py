"""Classic 2-D physics envs as functional envs."""

from gymnasium_tpu_torch.envs.phys2d.acrobot import AcrobotFunctional
from gymnasium_tpu_torch.envs.phys2d.cartpole import CartPoleFunctional
from gymnasium_tpu_torch.envs.phys2d.mountain_car import ContinuousMountainCarFunctional, MountainCarFunctional
from gymnasium_tpu_torch.envs.phys2d.pendulum import PendulumFunctional

__all__ = [
    "AcrobotFunctional",
    "CartPoleFunctional",
    "ContinuousMountainCarFunctional",
    "MountainCarFunctional",
    "PendulumFunctional",
]
