"""Dynamics shared by the functional envs and the kernels' plain versions."""
