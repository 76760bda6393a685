"""The arms' and pendulums' host env classes against the JAX package's,
through ``make``: the cases of ``tests/test_torch_mujoco_env.py`` for
Reacher, Pusher, InvertedPendulum and InvertedDoublePendulum, v4 and v5."""

import pytest

from tests.test_torch_mujoco_env import compare_with_jax

ROBOTS = ("Reacher", "Pusher", "InvertedPendulum", "InvertedDoublePendulum")


@pytest.mark.parametrize("env_id", [f"{name}-{v}" for name in ROBOTS for v in ("v4", "v5")])
def test_make_of_an_arm_id_matches_jax(env_id):
    compare_with_jax(env_id)
