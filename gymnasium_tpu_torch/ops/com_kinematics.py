"""Centre-of-mass kinematics: the generated CUDA kernels' wrapper and twins.

``velocity(q (N, nq), qd (N, nv)) -> (N, nbody, 3)``, each body's
centre-of-mass velocity in the world along the position flow ``q (+) t qd``
(the Humanoid's ``cvel`` block), and ``mass_center_x(q) -> (N,)``, the whole
robot's mass centre along x (the Humanoid's forward reward), in float32. On
a CUDA tensor a call is one launch of a kernel generated for the model
(:func:`~gymnasium_tpu_torch.ops.articulated_codegen.generate_com_source`,
with the fixed part in ``csrc/com_kinematics.cuh`` and ``csrc/staged_rows.cuh``):
one thread an env, the forward kinematics in registers. On a CPU tensor it runs the plain twin, the
same program over ``(N,)`` torch tensors. A failed build or launch raises; it
never gives way to the twin. :mod:`~gymnasium_tpu_torch.ops.model_kernel`
holds the checks, the build and the launch it shares with the contact
wrenches.

The JAX package has no kernel here: it takes the velocities as a forward
derivative of ``com_world`` and the mass centre from ``com_world``, plain
``jnp`` that XLA fuses.
"""

from __future__ import annotations

import collections

import torch

from gymnasium_tpu_torch.ops.articulated_codegen import (
    com_velocity_program,
    generate_com_source,
    mass_center_x_program,
)
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.ops.model_kernel import ModelKernel
from gymnasium_tpu_torch.physics.articulated import ArticulatedModel

__all__ = ["ComKinematics", "com_kinematics_of", "launches"]

#: Kernel launches, by the ``build_name`` of the model that made them, both
#: entry points together: Python calls of a launch (under a CUDA graph, its
#: capture only), not kernels on the card, which the profiler counts.
launches: collections.Counter[str] = collections.Counter()


class ComKinematics(ModelKernel):
    """``velocity(q, qd) -> (N, nbody, 3)`` and ``mass_center_x(q) -> (N,)``
    for one model."""

    prefix, what, launches = "com", "the com kinematics", launches

    def generate(self):
        return generate_com_source(self.model, self.name)

    def reference_velocity(self, q, qd):
        """The velocities' plain PyTorch twin, on any device."""
        self.check(q, qd)
        return self.twin_rows(com_velocity_program, q, qd, 3)

    def reference_mass_center_x(self, q):
        """The mass centre's plain PyTorch twin, on any device."""
        self.check(q)
        x = mass_center_x_program(self.tables, TorchOps(q.device), list(q.T.contiguous()))
        return torch.as_tensor(x, dtype=torch.float32, device=q.device).expand(q.shape[0])

    def velocity(self, q, qd):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if q.device.type == "cpu":
            return self.reference_velocity(q, qd)
        self.check(q, qd)
        v = torch.empty((q.shape[0], self.tables.nbody, 3), dtype=torch.float32, device=q.device)
        return self.launch("com_velocity_launch", (q, qd), v)

    def mass_center_x(self, q):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if q.device.type == "cpu":
            return self.reference_mass_center_x(q)
        self.check(q)
        x = torch.empty((q.shape[0],), dtype=torch.float32, device=q.device)
        return self.launch("mass_center_x_launch", (q,), x)


def com_kinematics_of(model: ArticulatedModel) -> ComKinematics:
    """The centre-of-mass kinematics of ``model``: :meth:`ModelKernel.of`,
    one object a process for each model's content."""
    return ComKinematics.of(model)
