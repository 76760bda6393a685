"""Contact wrenches: the generated CUDA kernel's wrapper and its twin.

``contact_wrenches(q (N, nq), qd (N, nv)) -> (N, nbody, 6)`` in float32, each
body's external contact wrench ``[torque, force]`` about its com (MuJoCo's
``cfrc_ext`` without the world row), as
:func:`~gymnasium_tpu_torch.physics.articulated.make_dynamics` hands it to
the robots' observations and rewards. On a CUDA tensor a call is one launch
of a kernel generated for the model
(:func:`~gymnasium_tpu_torch.ops.articulated_codegen.generate_wrench_source`,
with the fixed part in ``csrc/contact_wrenches.cuh`` and
``csrc/staged_rows.cuh``): one thread an env, the forward kinematics and the
substep's contact forces in registers. On a CPU tensor it runs the plain
twin, the same program over ``(N,)`` torch tensors. A failed build or launch
raises; it never gives way to the twin. :mod:`~gymnasium_tpu_torch.ops.model_kernel`
holds the checks, the build and the launch it shares with the centre-of-mass
kernels.

The JAX package has no kernel here: it writes the wrenches as plain ``jnp``,
which XLA fuses.
"""

from __future__ import annotations

import collections

import torch

from gymnasium_tpu_torch.ops.articulated_codegen import generate_wrench_source, wrench_program
from gymnasium_tpu_torch.ops.model_kernel import ModelKernel
from gymnasium_tpu_torch.physics.articulated import ArticulatedModel

__all__ = ["ContactWrenches", "contact_wrenches_of", "launches"]

#: Kernel launches, by the ``build_name`` of the model that made them: Python
#: calls of the launch (under a CUDA graph, its capture only), not kernels on
#: the card, which the profiler counts.
launches: collections.Counter[str] = collections.Counter()


class ContactWrenches(ModelKernel):
    """``wrenches(q, qd) -> (N, nbody, 6)`` for one model (the generator
    refuses a model without contact spheres, whose wrenches are zeros)."""

    prefix, what, launches = "wrenches", "the contact wrenches", launches

    def generate(self):
        return generate_wrench_source(self.model, self.name)

    def reference(self, q, qd):
        """The plain PyTorch twin, on any device."""
        self.check(q, qd)
        return self.twin_rows(wrench_program, q, qd, 6)

    def __call__(self, q, qd):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if q.device.type == "cpu":
            return self.reference(q, qd)
        self.check(q, qd)
        w = torch.empty((q.shape[0], self.tables.nbody, 6), dtype=torch.float32, device=q.device)
        return self.launch("contact_wrenches_launch", (q, qd), w)


def contact_wrenches_of(model: ArticulatedModel) -> ContactWrenches:
    """The contact wrenches of ``model``: :meth:`ModelKernel.of`, one object
    a process for each model's content."""
    return ContactWrenches.of(model)
