"""Humanoid of the port through ``TorchVectorEnv`` against the JAX
functional through ``JaxVectorEnv``, across autoresets, as
``tests/test_torch_mujoco_robots_vector.py`` holds the lighter robots (a
file of its own: its JAX hooks take about 13 s to compile on a CPU, and its
twin about 0.9 s an env step).
"""

from tests.test_torch_mujoco_robots_vector import run_against_jax


def test_humanoid_vector_env_matches_jax_across_autoresets(request):
    run_against_jax(request, "humanoid")
