"""MuJoCo-class robots as functional envs over the articulated engine."""
