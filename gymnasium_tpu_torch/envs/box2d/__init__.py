"""Box2D-class environments as functional envs over the planar solver."""
