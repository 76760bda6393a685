"""Box2D-class environments as functional envs: LunarLander over the planar
solver, CarRacing with its pixels drawn on the device."""

from gymnasium_tpu_torch.envs.box2d.car_racing_functional import CarRacingFunctional

__all__ = ["CarRacingFunctional"]
