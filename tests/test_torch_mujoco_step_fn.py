"""``physics/articulated.py::step_fn`` of the port against the JAX package's.

On the same perturbed numpy states as ``tests/test_torch_mujoco_dynamics.py``
(every other lane in contact), JAX's ``step_fn`` vmapped and jitted on the
CPU, the port's on ``(N, ...)`` CPU tensors, where it is the fused step's
plain twin. Tolerance ``1e-5 * max |JAX| + 1e-6`` an output. The port's
``make_dynamics(model)["step"]`` is one substep of the same program:
``FRAME_SKIP`` of them equal ``step_fn`` in every bit.
"""

import jax
import numpy as np
import pytest
import torch

from gymnasium_tpu.envs.mujoco.mujoco_env import load_model as jax_load_model
from gymnasium_tpu.physics import articulated as jart
from gymnasium_tpu_torch.physics import articulated as art
from tests.test_torch_mujoco_dynamics import ROBOTS, _inputs
from tests.test_torch_mujoco_kinematics import assert_close

FRAME_SKIP = 2


@pytest.mark.parametrize("name", sorted(ROBOTS))
def test_step_fn_matches_jax_and_runs_the_substep_program(name):
    model, q, qd, ctrl = _inputs(name)
    want = jax.jit(jax.vmap(jart.step_fn(jax_load_model(name)[0], FRAME_SKIP)))(q, qd, ctrl)
    step = art.step_fn(model, FRAME_SKIP, name)
    assert step.frame_skip == FRAME_SKIP and step.build_name == f"articulated_{name}_fs{FRAME_SKIP}"
    tq, tqd, tctrl = (torch.from_numpy(x) for x in (q, qd, ctrl))
    got = step(tq, tqd, tctrl)
    for label, g, w in zip(("q", "qd"), got, want):
        assert_close(g.numpy(), np.asarray(w), label)
    # make_dynamics' step is one substep of the same program: FRAME_SKIP of
    # them give step_fn's bits
    dyn = art.make_dynamics(model)
    q1, qd1 = tq, tqd
    for _ in range(FRAME_SKIP):
        q1, qd1 = dyn["step"](q1, qd1, tctrl)
    for a, b in zip((q1, qd1), got):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
