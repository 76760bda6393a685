"""Box2D-class environments: the host env classes behind ``make(id)``
(LunarLander and BipedalWalker over the planar solver on the env's device,
CarRacing on the host), and the functional envs behind ``make_vec(id)``
(CarRacing with its pixels drawn on the device)."""

from gymnasium_tpu_torch.envs.box2d.bipedal_walker import (
    BipedalWalker,
    BipedalWalkerFunctional,
    BipedalWalkerHardcore,
)
from gymnasium_tpu_torch.envs.box2d.car_racing import CarRacing
from gymnasium_tpu_torch.envs.box2d.car_racing_functional import CarRacingFunctional
from gymnasium_tpu_torch.envs.box2d.lunar_lander import (
    LunarLander,
    LunarLanderContinuous,
    LunarLanderContinuousFunctional,
    LunarLanderFunctional,
)

__all__ = [
    "BipedalWalker",
    "BipedalWalkerHardcore",
    "CarRacing",
    "LunarLander",
    "LunarLanderContinuous",
    "BipedalWalkerFunctional",
    "CarRacingFunctional",
    "LunarLanderFunctional",
    "LunarLanderContinuousFunctional",
]
