"""Humanoid's host env class against the JAX package's, through ``make``
(the cases of ``tests/test_torch_mujoco_env.py``; a file of its own, as is
HumanoidStandup's, since JAX compiles the model's step for about 10 s and
the port's plain twin takes about 0.7 s a Humanoid step on the CPU).

Their observation reads the bodies' centre-of-mass velocities (a forward
derivative) and contact wrenches in float32, which the port computes in
another order than JAX: those 156 values of the reset observation are held
within ``1e-5 * max |JAX| + 1e-6`` of their block (cvel, cfrc_ext; largest
seen: 3.7e-9 for Humanoid, 1.5e-4 of wrenches up to about 1e4 for
HumanoidStandup, which lies on the floor), every other value of the reset
bit for bit.
"""

import numpy as np
import pytest

from tests.test_torch_mujoco_env import compare_with_jax

# 22 + 23 positions and velocities and 130 of cinert, then 78 of cvel, 17 of
# qfrc_actuator and 78 of cfrc_ext
KINEMATIC_OBS = np.r_[175:253, 270:348]


@pytest.mark.parametrize("env_id", ["Humanoid-v4", "Humanoid-v5"])
def test_make_of_a_humanoid_id_matches_jax(env_id):
    compare_with_jax(env_id, KINEMATIC_OBS)
