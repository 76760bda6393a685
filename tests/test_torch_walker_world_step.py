"""The port's batched ``world_step`` on BipedalWalker's world against one
eager ``jnp`` tick of the JAX package's ``physics/planar.py::world_step``.

An eager tick of the walker's world takes 5-8 s on the CPU, and a jit of it
more than a minute, so this file holds that one tick. The inputs are
``chip_smoke.walker_states``: the creation pose with its hips 0.53 m from
their anchors (the bounded sub-pull), assembled poses on, in and above the
ground past joint limits, motors of random actions, zero joint impulses and
live warm-start contact impulses; every side of the solver is reached
(asserted).
"""

import jax.numpy as jnp
import numpy as np
import torch

from chip_smoke import planar_branch_lanes, walker_states
from gymnasium_tpu.envs.box2d import bipedal_walker as BW
from gymnasium_tpu.physics.planar import world_step as jax_world_step
from gymnasium_tpu_torch.envs.box2d import bipedal_walker as walker
from gymnasium_tpu_torch.physics.planar import world_step

# The JAX kernel test's tolerances (tests/ops/test_pallas_planar.py:107-110).
ENGINE_TOL = {"rtol": 0.0, "atol": 2e-4}
IMPULSE_TOL = {"rtol": 0.0, "atol": 1e-4}


def test_port_world_step_matches_jax_on_the_walker_world(request):
    """One tick of the port's ``world_step`` on the walker's world (motors of
    random actions, zero joint impulses, live contact impulses, the env's
    heightfield lookup) against one eager ``jnp`` tick of JAX's: the JAX
    kernel test's tolerances. Largest seen: 1.5e-6 in the bodies, 2.4e-7 in
    the impulses."""
    inputs = walker_states(32, "cpu", seed=2)
    lanes = planar_branch_lanes(walker.walker_solver(), *inputs)
    assert all(count > 0 for count in lanes.values()), lanes
    bodies, _, terrain, _, cimp, ms, mt = inputs
    jimp = torch.zeros((bodies.shape[0], 4, 5))
    got_b, got_f, (got_j, got_c) = world_step(
        bodies, walker._WORLD, ms, mt, walker.ground_height_fn(terrain), warm_start=(jimp, cimp)
    )
    j = [jnp.asarray(x.numpy()) for x in (bodies, terrain, jimp, cimp, ms, mt)]
    want = jax_world_step(jnp, j[0], BW._WORLD, j[4], j[5], BW.ground_height_fn(jnp, j[1]), warm_start=(j[2], j[3]))
    for label, g, w, tol in (("bodies", got_b, want[0], ENGINE_TOL), ("jimp", got_j, want[2][0], IMPULSE_TOL),
                             ("cimp", got_c, want[2][1], IMPULSE_TOL)):
        request.node.user_properties.append((f"max_abs_d{label}", float(np.abs(g.numpy() - np.asarray(w)).max())))
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **tol, err_msg=label)
    np.testing.assert_array_equal(got_f.numpy(), np.asarray(want[1]))


