"""The wrapper shared by the kernels generated per articulated model.

A subclass (:class:`~gymnasium_tpu_torch.ops.contact_wrenches.ContactWrenches`,
:class:`~gymnasium_tpu_torch.ops.com_kinematics.ComKinematics`) names its
build's prefix, its generator and its module's ``launches`` counter, and
calls :meth:`ModelKernel.launch` with the C entry point of the generated
source. This holds what they share: the input checks, the source generated
once, the library built and loaded at the first launch (never on a CPU
tensor), the launch on the current stream without a sync and its count, the
plain twin's rows stacked into a batch, and one object a process for each
model's content (:meth:`ModelKernel.of`).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.articulated_codegen import GeneratedSource, model_tables
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.physics.articulated import ArticulatedModel, model_digest

__all__ = ["ModelKernel"]

_made: dict[tuple[type, str], ModelKernel] = {}


class ModelKernel:
    """One model's generated kernel, built under ``<prefix>_<name>``."""

    #: The build name's prefix.
    prefix: str
    #: What the kernel computes, for error messages.
    what: str
    #: The subclass module's launches, by ``build_name``: Python calls of a
    #: launch (under a CUDA graph, its capture only), not kernels on the
    #: card, which the profiler counts.
    launches: collections.Counter[str]

    def __init__(self, model: ArticulatedModel, name: str):
        self.model, self.name = model, name
        self.tables = model_tables(model)
        self._source = None
        self._launch = None  # the bound C entry points, by name, from the first launch

    def generate(self) -> GeneratedSource:
        """The model's kernel source (the subclass's generator)."""
        raise NotImplementedError

    @property
    def source(self) -> GeneratedSource:
        """The generated kernel source and its operation counts (made once)."""
        if self._source is None:
            self._source = self.generate()
        return self._source

    @property
    def build_name(self) -> str:
        return f"{self.prefix}_{self.name}"

    def check(self, q, qd=None) -> None:
        """Raise unless ``q`` is ``(N, nq)`` and ``qd``, when given,
        ``(N, nv)``, both float32 on one device, with ``N >= 1``."""
        t = self.tables
        n = q.shape[0] if isinstance(q, torch.Tensor) and q.dim() == 2 else -1
        for label, x, width in [("q", q, t.nq)] + ([] if qd is None else [("qd", qd, t.nv)]):
            if not isinstance(x, torch.Tensor) or x.dim() != 2 or x.shape != (n, width):
                raise ValueError(
                    f"{label} must be a ({n}, {width}) tensor, got {getattr(x, 'shape', type(x))}"
                )
            if x.dtype != torch.float32:
                raise ValueError(f"{label} must be float32, got {x.dtype}")
            if x.device != q.device:
                raise ValueError(f"{label} is on {x.device}, q on {q.device}")
        if n < 1:
            raise ValueError("the batch must hold at least one env")

    def twin_rows(self, program, q, qd, width: int) -> torch.Tensor:
        """``program(tables, ops, qrows, qdrows)``'s ``nbody * width``
        per-env values over torch tensors, as an ``(N, nbody, width)``
        float32 batch: a plain twin."""
        n = q.shape[0]
        rows = program(self.tables, TorchOps(q.device), list(q.T.contiguous()), list(qd.T.contiguous()))
        rows = [torch.as_tensor(r, dtype=torch.float32, device=q.device).expand(n) for r in rows]
        return torch.stack(rows, dim=1).reshape(n, self.tables.nbody, width)

    def launch(self, entry: str, inputs: tuple, out: torch.Tensor) -> torch.Tensor:
        """Launch the C entry point ``entry(*inputs, out, n, stream)`` of
        the generated source on the current stream, without synchronising,
        and count it; ``n`` is ``out``'s batch. Raises unless the inputs are
        contiguous CUDA tensors, or if the launch fails."""
        if inputs[0].device.type != "cuda":
            raise ValueError(f"{self.what} run on cuda or cpu tensors, got {inputs[0].device}")
        if not all(x.is_contiguous() for x in inputs):
            raise ValueError("q and qd must be contiguous")
        if self._launch is None:
            self._launch = {}
        fn = self._launch.get(entry)
        if fn is None:  # built and loaded at the first launch, and kept
            fn = getattr(build.load(self.build_name, self.source.text), entry)
            fn.argtypes = [ctypes.c_void_p] * (len(inputs) + 1) + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._launch[entry] = fn
        with torch.cuda.device(out.device):
            stream = torch.cuda.current_stream(out.device).cuda_stream
            rc = fn(*(x.data_ptr() for x in inputs), out.data_ptr(), out.shape[0], stream)
        if rc != 0:
            raise RuntimeError(f"{self.build_name} kernel launch failed with cudaError {rc}")
        self.launches[self.build_name] += 1
        return out

    @classmethod
    def of(cls, model: ArticulatedModel):
        """The kernel of ``model``, one object a process for each model's
        content (named ``<digest>``, the first 16 hex digits of
        :func:`~gymnasium_tpu_torch.physics.articulated.model_digest`), so
        its source is generated and built once whatever the number of envs
        that share the model."""
        name = model_digest(model)[:16]
        op = _made.get((cls, name))
        if op is None:
            op = _made[cls, name] = cls(model, name)
        return op
