"""The two backends the port's substep generators run over.

A generator (``ops/articulated_codegen.py``, ``ops/planar_codegen.py``) writes
its program once, over a small ops namespace (``cos``, ``sin``, ``sqrt``,
``floor``, ``abs``, ``maximum``, ``minimum``, ``where``, ``clip``;
arithmetic and comparisons through Python operators), and runs over:

- :class:`TorchOps`: the per-env values are ``(N,)`` float32 tensors, and the
  generator computes the program itself. This is a kernel's plain PyTorch
  twin.
- :class:`SymOps`: the values are :class:`Sym` nodes. Each operation appends
  one node, equal nodes are shared, and :func:`_statement` emits a live node
  (:func:`_live`) as one C statement (``const float t7 = t3 * t5;``), with
  every constant as a float32 literal (:func:`_literal`).

A python float stays a python float until it meets a per-env value, so
constants fold in float64 and round to float32 once, as a weakly typed python
scalar does in ``jnp``. Operations on constants alone fold in float32, as the
card would round them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["TorchOps", "Sym", "SymOps", "GeneratedSource"]


# ---------------------------------------------------------------------------
# Backend (a): torch tensors, the plain twin.


class TorchOps:
    """The ops namespace over float32 tensors on ``device``.

    A python number that reaches an op becomes a float32 tensor there, as a
    weakly typed python scalar does in ``jnp``.
    """

    def __init__(self, device):
        self.device = device

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.tensor(float(x), dtype=torch.float32, device=self.device)

    def cos(self, x):
        return torch.cos(self._tensor(x))

    def sin(self, x):
        return torch.sin(self._tensor(x))

    def sqrt(self, x):
        return torch.sqrt(self._tensor(x))

    def floor(self, x):
        return torch.floor(self._tensor(x))

    def abs(self, x):
        return torch.abs(self._tensor(x))

    def maximum(self, a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            return torch.maximum(a, b)
        if isinstance(a, torch.Tensor):
            return torch.clamp_min(a, float(b))
        if isinstance(b, torch.Tensor):
            return torch.clamp_min(b, float(a))
        return self._tensor(max(np.float32(a), np.float32(b)))

    def minimum(self, a, b):
        if isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor):
            return torch.minimum(a, b)
        if isinstance(a, torch.Tensor):
            return torch.clamp_max(a, float(b))
        if isinstance(b, torch.Tensor):
            return torch.clamp_max(b, float(a))
        return self._tensor(min(np.float32(a), np.float32(b)))

    def where(self, cond, a, b):
        if isinstance(cond, (bool, np.bool_)):
            return self._tensor(a if cond else b)
        return torch.where(cond, a, b)

    def clip(self, x, lo, hi):
        """``jnp.clip``: ``minimum(maximum(x, lo), hi)``; the bounds may be
        python floats or per-env tensors."""
        if isinstance(lo, torch.Tensor) or isinstance(hi, torch.Tensor):
            return self.minimum(self.maximum(x, lo), hi)
        return torch.clamp(self._tensor(x), lo, hi)


# ---------------------------------------------------------------------------
# Backend (b): symbolic nodes, emitted as C.

_C_BINARY = {
    "add": "+", "sub": "-", "mul": "*", "div": "/", "gt": ">", "lt": "<", "ge": ">=", "or": "||",
}
_C_CALL = {
    "sqrt": "sqrtf", "cos": "cosf", "sin": "sinf", "floor": "floorf", "abs": "fabsf",
    "max": "fmaxf", "min": "fminf",
}
_BOOL_RESULT = frozenset({"gt", "lt", "ge", "or"})
# operations on constants only are folded in float32, as the card would round them
_FOLD = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "neg": lambda a: -a,
    "sqrt": np.sqrt,
    "floor": np.floor,
    "abs": np.abs,
    "max": np.maximum,
    "min": np.minimum,
    "gt": lambda a, b: np.bool_(a > b),
    "lt": lambda a, b: np.bool_(a < b),
    "ge": lambda a, b: np.bool_(a >= b),
    "or": lambda a, b: np.bool_(a or b),
    "select": lambda c, a, b: a if c else b,
}


class Sym:
    """One value of the emitted program: an input, a constant or an operation."""

    __slots__ = ("prog", "id", "kind", "args", "dtype", "varying", "value")

    def __init__(self, prog, kind, args=(), dtype="f", varying=False, value=None):
        self.prog, self.kind, self.args = prog, kind, args
        self.dtype, self.varying, self.value = dtype, varying, value
        self.id = len(prog.nodes)
        prog.nodes.append(self)

    def __add__(self, o):
        return self.prog.op("add", self, o)

    def __radd__(self, o):
        return self.prog.op("add", o, self)

    def __sub__(self, o):
        return self.prog.op("sub", self, o)

    def __rsub__(self, o):
        return self.prog.op("sub", o, self)

    def __mul__(self, o):
        return self.prog.op("mul", self, o)

    def __rmul__(self, o):
        return self.prog.op("mul", o, self)

    def __truediv__(self, o):
        return self.prog.op("div", self, o)

    def __rtruediv__(self, o):
        return self.prog.op("div", o, self)

    def __neg__(self):
        return self.prog.op("neg", self)

    def __gt__(self, o):
        return self.prog.op("gt", self, o)

    def __lt__(self, o):
        return self.prog.op("lt", self, o)

    def __ge__(self, o):
        return self.prog.op("ge", self, o)

    def __or__(self, o):
        return self.prog.op("or", self, o)

    def __bool__(self):
        raise TypeError("a symbolic value has no truth value: the program cannot branch on data")


class SymOps:
    """The ops namespace over :class:`Sym` nodes; it owns the node list."""

    def __init__(self):
        self.nodes: list[Sym] = []
        self._memo: dict = {}

    def input(self, name: str, varying: bool) -> Sym:
        return Sym(self, "input", dtype="f", varying=varying, value=name)

    def const(self, value) -> Sym:
        if isinstance(value, (bool, np.bool_)):
            key, dtype, value = ("const", bool(value)), "b", np.bool_(value)
        else:
            value = np.float32(value)
            if not np.isfinite(value):
                raise ValueError(f"the program holds a non-finite constant {value}")
            key, dtype = ("const", "f", value.tobytes()), "f"
        node = self._memo.get(key)
        if node is None:
            node = self._memo[key] = Sym(self, "const", dtype=dtype, value=value)
        return node

    def op(self, kind: str, *args) -> Sym:
        args = tuple(a if isinstance(a, Sym) else self.const(a) for a in args)
        if all(a.kind == "const" for a in args) and kind in _FOLD:
            return self.const(_FOLD[kind](*(a.value for a in args)))
        key = (kind,) + tuple(a.id for a in args)
        node = self._memo.get(key)
        if node is None:
            if kind == "select":
                dtype = args[1].dtype
            else:
                dtype = "b" if kind in _BOOL_RESULT else "f"
            node = self._memo[key] = Sym(
                self, kind, args, dtype=dtype, varying=any(a.varying for a in args)
            )
        return node

    def cos(self, x):
        return self.op("cos", x)

    def sin(self, x):
        return self.op("sin", x)

    def sqrt(self, x):
        return self.op("sqrt", x)

    def floor(self, x):
        return self.op("floor", x)

    def abs(self, x):
        return self.op("abs", x)

    def maximum(self, a, b):
        return self.op("max", a, b)

    def minimum(self, a, b):
        return self.op("min", a, b)

    def where(self, cond, a, b):
        if isinstance(cond, (bool, np.bool_)):
            pick = a if cond else b
            return pick if isinstance(pick, Sym) else self.const(pick)
        return self.op("select", cond, a, b)

    def clip(self, x, lo, hi):
        # jnp.clip is minimum(maximum(x, lo), hi); the bounds may be nodes
        return self.op("min", self.op("max", x, lo), hi)


def _literal(value) -> str:
    if isinstance(value, np.bool_):
        return "true" if value else "false"
    text = "%.9g" % float(value)
    if not any(ch in text for ch in ".e"):
        text += ".0"
    text += "f"
    return f"({text})" if text.startswith("-") else text


def _ref(node: Sym) -> str:
    if node.kind == "const":
        return _literal(node.value)
    if node.kind == "input":
        return node.value
    return f"t{node.id}"


def _statement(node: Sym) -> str:
    ctype = "bool" if node.dtype == "b" else "float"
    args = [_ref(a) for a in node.args]
    if node.kind in _C_BINARY:
        expr = f"{args[0]} {_C_BINARY[node.kind]} {args[1]}"
    elif node.kind in _C_CALL:
        expr = f"{_C_CALL[node.kind]}({', '.join(args)})"
    elif node.kind == "neg":
        expr = f"-{args[0]}"
    elif node.kind == "select":
        expr = f"{args[0]} ? {args[1]} : {args[2]}"
    else:
        raise ValueError(f"no C form for {node.kind}")
    return f"const {ctype} t{node.id} = {expr};"


def _live(outputs) -> list[Sym]:
    """The operation nodes the outputs depend on, in creation order."""
    seen, stack = set(), [o for o in outputs if isinstance(o, Sym)]
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        stack.extend(node.args)
    prog = outputs[0].prog
    return [prog.nodes[i] for i in sorted(seen) if prog.nodes[i].kind not in ("const", "input")]


@dataclasses.dataclass(frozen=True)
class GeneratedSource:
    """An emitted kernel source and the count of each kind of operation it
    runs: once a call (the prologue) and in each pass of its substep loop."""

    name: str
    substeps: int  # passes of the substep loop a call (an articulated step's frame_skip)
    text: str
    prologue_ops: dict  # kind -> count, run once a call
    substep_ops: dict  # kind -> count, run `substeps` times a call

    @property
    def ops_per_env(self) -> int:
        """Operations one env's call runs: the prologue plus every substep."""
        return sum(self.prologue_ops.values()) + self.substeps * sum(self.substep_ops.values())
