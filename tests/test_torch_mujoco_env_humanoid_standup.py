"""HumanoidStandup's host env class against the JAX package's, through
``make``: the cases of ``tests/test_torch_mujoco_env_humanoid.py``, whose
observation layout it shares."""

import pytest

from tests.test_torch_mujoco_env import compare_with_jax
from tests.test_torch_mujoco_env_humanoid import KINEMATIC_OBS


@pytest.mark.parametrize("env_id", ["HumanoidStandup-v4", "HumanoidStandup-v5"])
def test_make_of_a_humanoid_standup_id_matches_jax(env_id):
    compare_with_jax(env_id, KINEMATIC_OBS)
