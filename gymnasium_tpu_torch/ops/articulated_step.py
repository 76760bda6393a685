"""Fused articulated substep: the generated CUDA kernel's wrapper and its twin.

Counterpart of the JAX package's ``ops/pallas_articulated.py::make_fused_step``
with the same batch-first signature, ``(q (N, nq), qd (N, nv), ctrl (N, nu))
-> (q', qd')`` in float32, running ``frame_skip`` substeps of the MuJoCo-class
engine. On a CUDA tensor the step launches a kernel generated for the model
(:func:`~gymnasium_tpu_torch.ops.articulated_codegen.generate_source`, with
the fixed part in ``csrc/articulated_step.cuh``) in the layout the
generator's layout model picks for the robot
(``articulated_codegen.choose_layout``): several warps a group of 32 envs,
one partition of the substep each, or one thread an env, the whole step in
registers. On a CPU tensor it runs the plain twin, the same generator over
``(N,)`` torch tensors. A failed build or launch raises; it
never gives way to the twin.
"""

from __future__ import annotations

import collections
import ctypes
import functools

import torch

from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.articulated_codegen import (
    clip_controls,
    generate_source,
    make_substep,
    model_tables,
)
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.physics.articulated import ArticulatedModel

__all__ = ["make_fused_step", "fused_step", "launches"]

#: Kernel launches, by the ``build_name`` of the step that made them: Python
#: calls of the launch (under a CUDA graph, its capture only), not kernels on
#: the card, which the profiler counts.
launches: collections.Counter[str] = collections.Counter()


def _twin(tables, frame_skip: int, q, qd, ctrl):
    """``frame_skip`` substeps over the columns of ``q``, ``qd``, ``ctrl``."""
    ops = TorchOps(q.device)
    qrows, qdrows = list(q.T.contiguous()), list(qd.T.contiguous())
    substep = make_substep(tables, ops, clip_controls(tables, ops, list(ctrl.T.contiguous())))
    for _ in range(frame_skip):
        qrows, qdrows = substep(qrows, qdrows)
    return torch.stack(qrows, dim=1), torch.stack(qdrows, dim=1)


class FusedStep:
    """``step(q, qd, ctrl) -> (q', qd')`` for one ``(model, frame_skip)``."""

    def __init__(self, model: ArticulatedModel, frame_skip: int = 1, name: str = "model"):
        if frame_skip < 1:
            raise ValueError(f"frame_skip must be at least 1, got {frame_skip}")
        self.model, self.frame_skip, self.name = model, frame_skip, name
        self.tables = model_tables(model)
        self._source = None
        self._launch = None

    @property
    def source(self):
        """The generated kernel source and its operation counts (made once)."""
        if self._source is None:
            self._source = generate_source(self.model, self.frame_skip, self.name)
        return self._source

    @property
    def build_name(self) -> str:
        return f"articulated_{self.name}_fs{self.frame_skip}"

    def _check(self, q, qd, ctrl):
        m = self.model
        n = q.shape[0] if q.dim() == 2 else -1
        for label, x, width in (("q", q, m.nq), ("qd", qd, m.nv), ("ctrl", ctrl, m.nu)):
            if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape != (n, width):
                raise ValueError(
                    f"{label} must be a ({n}, {width}) tensor, got {getattr(x, 'shape', type(x))}"
                )
            if x.device != q.device:
                raise ValueError(f"{label} is on {x.device}, q on {q.device}")
        if n < 1:
            raise ValueError("the batch must hold at least one env")

    def reference(self, q, qd, ctrl):
        """The plain PyTorch twin, on any device."""
        self._check(q, qd, ctrl)
        f32 = [x.to(torch.float32) for x in (q, qd, ctrl)]
        return _twin(self.tables, self.frame_skip, *f32)

    def _launcher(self):
        """The kernel's C launcher, built and loaded at the first call and
        kept, so later calls pay no lookup of the source."""
        if self._launch is None:
            fn = build.load(self.build_name, self.source.text).articulated_step_launch
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._launch = fn
        return self._launch

    def __call__(self, q, qd, ctrl):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if q.device.type == "cpu":
            return self.reference(q, qd, ctrl)
        self._check(q, qd, ctrl)
        if q.device.type != "cuda":
            raise ValueError(f"the fused step runs on cuda or cpu tensors, got {q.device}")
        q, qd, ctrl = (x.to(torch.float32).contiguous() for x in (q, qd, ctrl))
        n = q.shape[0]
        q_out, qd_out = torch.empty_like(q), torch.empty_like(qd)
        launch = self._launcher()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = launch(
                q.data_ptr(), qd.data_ptr(), ctrl.data_ptr(),
                q_out.data_ptr(), qd_out.data_ptr(), n, stream,
            )
        if rc != 0:
            raise RuntimeError(f"{self.build_name} kernel launch failed with cudaError {rc}")
        launches[self.build_name] += 1
        return q_out, qd_out


def make_fused_step(model: ArticulatedModel, frame_skip: int = 1, name: str = "model") -> FusedStep:
    """The fused step of ``frame_skip`` substeps of ``model``.

    ``name`` names the generated source and its library; models that differ
    must not share it. The kernel's layout is the layout model's choice for
    the model (``articulated_codegen.choose_layout``); it is generated and
    built at its first launch.
    """
    return FusedStep(model, frame_skip, name)


def fused_step(model_name: str, frame_skip: int) -> FusedStep:
    """The fused step of a robot of ``envs/mujoco/models``, or of an ``.xml``
    model, cached per ``(kernel name, frame_skip)``: an XML model is built
    and counted under ``envs.mujoco.mujoco_env.kernel_name``, which tells
    two files apart."""
    # imported here: the robots of envs.mujoco import this module
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import kernel_name, resolve_xml

    source = resolve_xml(model_name) if model_name.endswith(".xml") else model_name
    return _fused_step(kernel_name(source), frame_skip, source)


@functools.lru_cache(maxsize=32)
def _fused_step(name: str, frame_skip: int, source: str) -> FusedStep:
    from gymnasium_tpu_torch.envs.mujoco.mujoco_env import load_model

    model, _ = load_model(source)
    return FusedStep(model, frame_skip, name)
