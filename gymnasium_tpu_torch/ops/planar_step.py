"""Fused planar solver step: the generated CUDA kernel's wrapper and its twin.

Counterpart of the JAX package's ``ops/pallas_planar.py::make_fused_planar_step``
with the same batch-first signature, ``(bodies (N, B, 6), external (N, B, 3),
terrain (N, chunks), jimp (N, J, 5), cimp (N, C, 2)) -> (bodies', jimp',
cimp', flags (N, C) bool)`` in float32, running ``substeps`` ticks of the
Box2D-class solver. The TPU kernel's 1024-env multiple and (8, 128) row
blocks are gone: any N works. On a CUDA tensor the step launches a kernel
generated for the world
(:func:`~gymnasium_tpu_torch.ops.planar_codegen.generate_planar_source`, with
the fixed part in ``csrc/planar_step.cuh``): one thread per env, the whole
call in registers. On a CPU tensor it runs the plain twin, the same generator
over ``(N,)`` torch tensors. A failed build or launch raises; it never gives
way to the twin.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.ops.planar_codegen import (
    generate_planar_source,
    make_substep,
    planar_tables,
)
from gymnasium_tpu_torch.physics.planar import PlanarWorld

__all__ = ["FusedPlanarStep", "make_fused_planar_step", "launches"]

#: Kernel launches, by the ``build_name`` of the step that made them.
launches: collections.Counter[str] = collections.Counter()


class FusedPlanarStep:
    """``step(bodies, external, terrain, jimp, cimp) -> (bodies', jimp', cimp',
    flags)`` for one world, terrain layout and substep count."""

    def __init__(
        self,
        world: PlanarWorld,
        chunks: int,
        spacing: float,
        motor_speed,
        motor_torque,
        substeps: int = 2,
        name: str = "world",
    ):
        self.world, self.name = world, name
        self._args = (world, chunks, spacing, motor_speed, motor_torque, substeps)
        self.tables = planar_tables(*self._args)
        self._source = None
        self._launch = None

    @property
    def substeps(self) -> int:
        return self.tables.substeps

    @property
    def source(self):
        """The generated kernel source and its operation counts (made once)."""
        if self._source is None:
            self._source = generate_planar_source(*self._args, self.name)
        return self._source

    @property
    def build_name(self) -> str:
        return f"planar_{self.name}_ss{self.substeps}"

    def _check(self, bodies, external, terrain, jimp, cimp):
        t = self.tables
        n = bodies.shape[0] if isinstance(bodies, torch.Tensor) and bodies.dim() == 3 else -1
        for label, x, shape in (
            ("bodies", bodies, (n, t.nbody, 6)),
            ("external", external, (n, t.nbody, 3)),
            ("terrain", terrain, (n, t.chunks)),
            ("jimp", jimp, (n, t.njoint, 5)),
            ("cimp", cimp, (n, t.ncontact, 2)),
        ):
            if not isinstance(x, torch.Tensor) or tuple(x.shape) != shape:
                raise ValueError(
                    f"{label} must be a {shape} tensor, got {getattr(x, 'shape', type(x))}"
                )
            if x.device != bodies.device:
                raise ValueError(f"{label} is on {x.device}, bodies on {bodies.device}")
            if not x.is_floating_point():
                raise ValueError(f"{label} must hold floats, got {x.dtype}")
        if n < 1:
            raise ValueError("the batch must hold at least one env")

    def reference(self, bodies, external, terrain, jimp, cimp):
        """The plain PyTorch twin, on any device."""
        self._check(bodies, external, terrain, jimp, cimp)
        t = self.tables
        substep = make_substep(t, TorchOps(bodies.device))
        f32 = [x.to(torch.float32) for x in (bodies, external, terrain, jimp, cimp)]
        body = [list(f32[0][:, b].T.contiguous()) for b in range(t.nbody)]
        ext = [list(f32[1][:, b].T.contiguous()) for b in range(t.nbody)]
        t_rows = list(f32[2].T.contiguous())
        jrows = [list(f32[3][:, j].T.contiguous()) for j in range(t.njoint)]
        crows = [list(f32[4][:, k].T.contiguous()) for k in range(t.ncontact)]
        flags = None
        for _ in range(t.substeps):
            body, jrows, crows, flags = substep(body, ext, t_rows, jrows, crows)
        n = bodies.shape[0]

        def stack(rows, width):
            if not rows:
                return torch.zeros((n, 0, width), dtype=torch.float32, device=bodies.device)
            return torch.stack([torch.stack(r, dim=1) for r in rows], dim=1)

        return stack(body, 6), stack(jrows, 5), stack(crows, 2), torch.stack(flags, dim=1)

    def _launcher(self):
        """The kernel's C launcher, built and loaded at the first call and
        kept, so later calls pay no lookup of the source."""
        if self._launch is None:
            fn = build.load(self.build_name, self.source.text).planar_step_launch
            fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._launch = fn
        return self._launch

    def __call__(self, bodies, external, terrain, jimp, cimp):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if bodies.device.type == "cpu":
            return self.reference(bodies, external, terrain, jimp, cimp)
        self._check(bodies, external, terrain, jimp, cimp)
        if bodies.device.type != "cuda":
            raise ValueError(f"the fused planar step runs on cuda or cpu tensors, got {bodies.device}")
        ins = [x.to(torch.float32).contiguous() for x in (bodies, external, terrain, jimp, cimp)]
        n, t = ins[0].shape[0], self.tables
        bodies_out, jimp_out, cimp_out = (torch.empty_like(ins[i]) for i in (0, 3, 4))
        flags = torch.empty((n, t.ncontact), dtype=torch.bool, device=bodies.device)
        launch = self._launcher()
        with torch.cuda.device(bodies.device):
            stream = torch.cuda.current_stream(bodies.device).cuda_stream
            rc = launch(
                *(x.data_ptr() for x in ins),
                bodies_out.data_ptr(), jimp_out.data_ptr(), cimp_out.data_ptr(), flags.data_ptr(),
                n, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.build_name} kernel launch failed with cudaError {rc}")
        launches[self.build_name] += 1
        return bodies_out, jimp_out, cimp_out, flags


def make_fused_planar_step(
    world: PlanarWorld,
    chunks: int,
    spacing: float,
    motor_speed,
    motor_torque,
    substeps: int = 2,
    name: str = "world",
) -> FusedPlanarStep:
    """The fused step of ``substeps`` solver ticks of ``world`` over a
    piecewise-linear terrain of ``chunks`` heights ``spacing`` apart, with
    the joint motors' speeds and torques as constants.

    ``name`` names the generated source and its library; worlds that differ
    must not share it. The kernel is generated and built at its first launch.
    Raises ``NotImplementedError`` for a world with a joint correction clamp.
    """
    return FusedPlanarStep(world, chunks, spacing, motor_speed, motor_torque, substeps, name)
