"""Classic 2-D physics envs as functional envs."""
