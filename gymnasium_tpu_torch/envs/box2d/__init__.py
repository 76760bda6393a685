"""Box2D-class environments as functional envs: LunarLander and BipedalWalker
over the planar solver, CarRacing with its pixels drawn on the device."""

from gymnasium_tpu_torch.envs.box2d.bipedal_walker import BipedalWalkerFunctional, BipedalWalkerHardcore
from gymnasium_tpu_torch.envs.box2d.car_racing_functional import CarRacingFunctional

__all__ = ["BipedalWalkerFunctional", "BipedalWalkerHardcore", "CarRacingFunctional"]
