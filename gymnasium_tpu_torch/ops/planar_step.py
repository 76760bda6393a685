"""Fused planar solver step: the generated CUDA kernel's wrapper and its twin.

Counterpart of the JAX package's ``ops/pallas_planar.py::make_fused_planar_step``
with the same batch-first signature, ``(bodies (N, B, 6), external (N, B, 3),
terrain (N, chunks), jimp (N, J, 5), cimp (N, C, 2)) -> (bodies', jimp',
cimp', flags (N, C) bool)`` in float32, running ``substeps`` ticks of the
Box2D-class solver. A world may also take per-env motor speeds and torques
((N, J) each), start each tick from zero joint impulses, apply no external
force, and read its terrain as a heightfield by index (BipedalWalker's
world, four ticks a launch). The TPU kernel's 1024-env multiple and (8, 128) row
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
import hashlib

import torch

from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.ops.planar_codegen import (
    ChunkTerrain,
    Heightfield,
    generate_planar_source,
    planar_tables,
    run_twin,
)
from gymnasium_tpu_torch.physics.planar import PlanarWorld

__all__ = ["FusedPlanarStep", "make_fused_planar_step", "launches"]

#: Kernel launches, by the ``build_name`` of the step that made them.
launches: collections.Counter[str] = collections.Counter()


class FusedPlanarStep:
    """``step(bodies, external, terrain, jimp, cimp, motor_speed=None,
    motor_torque=None) -> (bodies', jimp', cimp', flags)`` for one world,
    terrain layout and substep count.

    ``motors`` is ``(motor_speed, motor_torque)``, folded into the kernel, or
    None: then each call passes ``(N, J)`` tensors of them. A step built with
    ``carry_joints=False`` starts each tick from zero joint impulses, takes
    ``jimp=None`` and returns ``jimp'`` None; one built with
    ``external=False`` takes ``external=None``.
    """

    def __init__(
        self,
        world: PlanarWorld,
        terrain: ChunkTerrain | Heightfield,
        motors=None,
        substeps: int = 2,
        carry_joints: bool = True,
        external: bool = True,
        name: str = "world",
    ):
        self.world, self.name = world, name
        self._args = (world, terrain, motors, substeps, carry_joints, external)
        self.tables = planar_tables(*self._args)
        self._digest = hashlib.sha256(repr(self.tables).encode()).hexdigest()[:8]
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
        """The name, the substep count and a digest of the tables the text
        is generated from: steps that differ never share a launch count."""
        return f"planar_{self.name}_ss{self.substeps}_{self._digest}"

    def _check(self, bodies, external, terrain, jimp, cimp, motor_speed, motor_torque):
        t = self.tables
        n = bodies.shape[0] if isinstance(bodies, torch.Tensor) and bodies.dim() == 3 else -1
        parts = [("bodies", bodies, (n, t.nbody, 6), True),
                 ("external", external, (n, t.nbody, 3), t.external),
                 ("terrain", terrain, (n, t.chunks), True),
                 ("jimp", jimp, (n, t.njoint, 5), t.carry_joints),
                 ("cimp", cimp, (n, t.ncontact, 2), True),
                 ("motor_speed", motor_speed, (n, t.njoint), t.motor_speed is None),
                 ("motor_torque", motor_torque, (n, t.njoint), t.motor_speed is None)]
        for label, x, shape, wanted in parts:
            if not wanted:
                if x is not None:
                    raise ValueError(f"{label} must be None for this step, got {type(x).__name__}")
                continue
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

    def reference(self, bodies, external, terrain, jimp, cimp, motor_speed=None, motor_torque=None):
        """The plain PyTorch twin, on any device."""
        self._check(bodies, external, terrain, jimp, cimp, motor_speed, motor_torque)
        t = self.tables
        ops = TorchOps(bodies.device)
        ground = t.terrain.ground(ops, t.terrain.rows(terrain.to(torch.float32)))
        return run_twin(t, ops, ground, bodies, external, jimp, cimp, motor_speed, motor_torque)

    def _launcher(self):
        """The kernel's C launcher, built and loaded at the first call and
        kept, so later calls pay no lookup of the source."""
        if self._launch is None:
            fn = build.load(self.build_name, self.source.text).planar_step_launch
            fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._launch = fn
        return self._launch

    def __call__(self, bodies, external, terrain, jimp, cimp, motor_speed=None, motor_torque=None):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if bodies.device.type == "cpu":
            return self.reference(bodies, external, terrain, jimp, cimp, motor_speed, motor_torque)
        self._check(bodies, external, terrain, jimp, cimp, motor_speed, motor_torque)
        if bodies.device.type != "cuda":
            raise ValueError(f"the fused planar step runs on cuda or cpu tensors, got {bodies.device}")
        ins = [None if x is None else x.to(torch.float32).contiguous()
               for x in (bodies, external, terrain, jimp, cimp, motor_speed, motor_torque)]
        n, t = ins[0].shape[0], self.tables
        bodies_out, cimp_out = torch.empty_like(ins[0]), torch.empty_like(ins[4])
        jimp_out = torch.empty_like(ins[3]) if t.carry_joints else None
        flags = torch.empty((n, t.ncontact), dtype=torch.bool, device=bodies.device)
        launch = self._launcher()

        def ptr(x):
            return None if x is None else x.data_ptr()

        with torch.cuda.device(bodies.device):
            stream = torch.cuda.current_stream(bodies.device).cuda_stream
            rc = launch(*(ptr(x) for x in ins), ptr(bodies_out), ptr(jimp_out), ptr(cimp_out),
                        ptr(flags), n, stream)
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
    piecewise-linear terrain of ``chunks`` heights ``spacing`` apart (read
    as :class:`ChunkTerrain`), with the joint motors' speeds and torques as
    constants, as the JAX package's ``make_fused_planar_step`` takes them.

    ``name`` names the generated source and its library. The kernel is
    generated and built at its first launch.
    """
    return FusedPlanarStep(
        world, ChunkTerrain(chunks, spacing), (motor_speed, motor_torque), substeps, name=name
    )
