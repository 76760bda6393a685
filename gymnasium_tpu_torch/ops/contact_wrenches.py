"""Contact wrenches: the generated CUDA kernel's wrapper and its twin.

``contact_wrenches(q (N, nq), qd (N, nv)) -> (N, nbody, 6)`` in float32, each
body's external contact wrench ``[torque, force]`` about its com (MuJoCo's
``cfrc_ext`` without the world row), as
:func:`~gymnasium_tpu_torch.physics.articulated.make_dynamics` hands it to
the robots' observations and rewards. On a CUDA tensor a call is one launch
of a kernel generated for the model
(:func:`~gymnasium_tpu_torch.ops.articulated_codegen.generate_wrench_source`,
with the fixed part in ``csrc/contact_wrenches.cuh``): one thread an env,
the forward kinematics and the substep's contact forces in registers. On a
CPU tensor it runs the plain twin, the same program over ``(N,)`` torch
tensors. A failed build or launch raises; it never gives way to the twin.

The JAX package has no kernel here: it writes the wrenches as plain ``jnp``,
which XLA fuses.
"""

from __future__ import annotations

import collections
import ctypes

import torch

from gymnasium_tpu_torch.ops import build
from gymnasium_tpu_torch.ops.articulated_codegen import generate_wrench_source, model_tables, wrench_program
from gymnasium_tpu_torch.ops.codegen import TorchOps
from gymnasium_tpu_torch.physics.articulated import ArticulatedModel, model_digest

__all__ = ["ContactWrenches", "contact_wrenches_of", "launches"]

#: Kernel launches, by the ``build_name`` of the model that made them: Python
#: calls of the launch (under a CUDA graph, its capture only), not kernels on
#: the card, which the profiler counts.
launches: collections.Counter[str] = collections.Counter()


class ContactWrenches:
    """``wrenches(q, qd) -> (N, nbody, 6)`` for one model (the generator
    refuses a model without contact spheres, whose wrenches are zeros)."""

    def __init__(self, model: ArticulatedModel, name: str):
        self.model, self.name = model, name
        self.tables = model_tables(model)
        self._source = None
        self._launch = None

    @property
    def source(self):
        """The generated kernel source and its operation counts (made once)."""
        if self._source is None:
            self._source = generate_wrench_source(self.model, self.name)
        return self._source

    @property
    def build_name(self) -> str:
        return f"wrenches_{self.name}"

    def _check(self, q, qd):
        t = self.tables
        n = q.shape[0] if isinstance(q, torch.Tensor) and q.dim() == 2 else -1
        for label, x, width in (("q", q, t.nq), ("qd", qd, t.nv)):
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

    def reference(self, q, qd):
        """The plain PyTorch twin, on any device."""
        self._check(q, qd)
        n = q.shape[0]
        rows = wrench_program(self.tables, TorchOps(q.device), list(q.T.contiguous()), list(qd.T.contiguous()))
        rows = [torch.as_tensor(r, dtype=torch.float32, device=q.device).expand(n) for r in rows]
        return torch.stack(rows, dim=1).reshape(n, self.tables.nbody, 6)

    def _launcher(self):
        """The kernel's C launcher, built and loaded at the first call and
        kept, so later calls pay no generation or lookup of the source."""
        if self._launch is None:
            fn = build.load(self.build_name, self.source.text).contact_wrenches_launch
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._launch = fn
        return self._launch

    def __call__(self, q, qd):
        """A CPU tensor runs the twin; a CUDA tensor launches the kernel on
        the current stream without synchronising, or raises."""
        if q.device.type == "cpu":
            return self.reference(q, qd)
        self._check(q, qd)
        if q.device.type != "cuda":
            raise ValueError(f"the contact wrenches run on cuda or cpu tensors, got {q.device}")
        if not (q.is_contiguous() and qd.is_contiguous()):
            raise ValueError("q and qd must be contiguous")
        n = q.shape[0]
        w = torch.empty((n, self.tables.nbody, 6), dtype=torch.float32, device=q.device)
        launch = self._launcher()
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            rc = launch(q.data_ptr(), qd.data_ptr(), w.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"{self.build_name} kernel launch failed with cudaError {rc}")
        launches[self.build_name] += 1
        return w


_made: dict[str, ContactWrenches] = {}


def contact_wrenches_of(model: ArticulatedModel) -> ContactWrenches:
    """The contact wrenches of ``model``, one object a process for each
    model's content (named ``<digest>``, the first 16 hex digits of
    :func:`~gymnasium_tpu_torch.physics.articulated.model_digest`), so its
    source is generated and built once whatever the number of envs that
    share the model."""
    name = model_digest(model)[:16]
    op = _made.get(name)
    if op is None:
        op = _made[name] = ContactWrenches(model, name)
    return op
