"""The two backends the port's substep generators run over.

A generator (``ops/articulated_codegen.py``, ``ops/planar_codegen.py``) writes
its program once, over a small ops namespace (``cos``, ``sin``, ``sincos``,
``sqrt``, ``floor``, ``abs``, ``maximum``, ``minimum``, ``where``, ``clip``,
``div``, the indexed ``load`` from an env's row and the loop ``repeat``;
arithmetic and comparisons through Python operators), and runs over:

- :class:`TorchOps`: the per-env values are ``(N,)`` float32 tensors, and the
  generator computes the program itself. This is a kernel's plain PyTorch
  twin.
- :class:`SymOps`: the values are :class:`Sym` nodes. Each operation appends
  one node, equal nodes are shared, and :func:`_statement` emits a live node
  (:func:`_live`) as one C statement (``const float t7 = t3 * t5;``), with
  every constant as a float32 literal (:func:`_literal`).

``repeat(n, carried, body)`` runs ``body`` n times over a flat list of
per-env values. Over ``TorchOps`` it is that Python loop. Over ``SymOps`` it
traces ``body`` once on fresh loop-carried values, and :func:`emit` writes it
as one ``for`` loop that is not unrolled. Every node of the body that does
not depend on the carried values is emitted once, before the loop: those are
the nodes that sharing equal nodes computes once in the unrolled program, so
both forms run the same operations, with the same rounding.

A python float stays a python float until it meets a per-env value, so
constants fold in float64 and round to float32 once, as a weakly typed python
scalar does in ``jnp``. Operations on constants alone fold in float32, as the
card would round them. A python float divided by a per-env value goes
through ``ops.div``: torch computes ``float / tensor`` as a reciprocal times
the float, which rounds twice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["TorchOps", "Sym", "SymOps", "GeneratedSource", "emit", "op_counts"]


# ---------------------------------------------------------------------------
# Backend (a): torch tensors, the plain twin.


class TorchOps:
    """The ops namespace over float32 tensors on ``device``.

    A python number that reaches an op becomes a float32 tensor there, as a
    weakly typed python scalar does in ``jnp``.
    """

    def __init__(self, device):
        self.device = device
        self._scalars: dict[float, torch.Tensor] = {}  # each python number's tensor, made once

    def _tensor(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        value = float(x)
        scalar = self._scalars.get(value)
        if scalar is None:
            scalar = self._scalars[value] = torch.tensor(value, dtype=torch.float32, device=self.device)
        return scalar

    def cos(self, x):
        return torch.cos(self._tensor(x))

    def sin(self, x):
        return torch.sin(self._tensor(x))

    def sincos(self, x):
        """``(sin(x), cos(x))``."""
        x = self._tensor(x)
        return torch.sin(x), torch.cos(x)

    def repeat(self, n: int, carried, body):
        """``body`` applied ``n`` times to the list ``carried``."""
        carried = list(carried)
        for _ in range(n):
            carried = list(body(carried))
        return carried

    def sqrt(self, x):
        return torch.sqrt(self._tensor(x))

    def floor(self, x):
        return torch.floor(self._tensor(x))

    def abs(self, x):
        return torch.abs(self._tensor(x))

    def div(self, a, b):
        """``a / b`` rounded once, whichever operand is a python float."""
        return torch.div(self._tensor(a), self._tensor(b))

    def load(self, row, index):
        """``row[i, index[i]]`` of an ``(N, K)`` row, ``index`` an ``(N,)``
        tensor of whole floats in ``[0, K)``."""
        return torch.gather(row, 1, index.long().unsqueeze(1)).squeeze(1)

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
# nodes that name a value but are no statement of their own: a loop-carried
# value, a loop's result, one result of a sincos
_NO_STATEMENT = frozenset({"const", "input", "carry", "loopout", "part"})
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


class _Loop:
    """One ``repeat``: its trip count, the loop it sits in, its carried values."""

    def __init__(self, n: int, parent):
        self.n, self.parent = n, parent
        self.depth = 1 + (parent.depth if parent is not None else 0)
        self.carries: list = []

    def trips(self) -> int:
        """Passes of this loop's body a pass of the code around every loop."""
        return self.n * (self.parent.trips() if self.parent is not None else 1)


def _depth(scope) -> int:
    return 0 if scope is None else scope.depth


class Sym:
    """One value of the emitted program: an input, a constant or an operation.

    ``scope`` is the innermost loop whose carried values it depends on (None
    outside every loop): the node is emitted in that loop's body.
    """

    __slots__ = ("prog", "id", "kind", "args", "dtype", "varying", "value", "scope")

    def __init__(self, prog, kind, args=(), dtype="f", varying=False, value=None, scope=None):
        self.prog, self.kind, self.args = prog, kind, args
        self.dtype, self.varying, self.value, self.scope = dtype, varying, value, scope
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
        self._loops: list[_Loop] = []  # the loops whose body is being traced, innermost last

    def input(self, name: str, varying: bool) -> Sym:
        return Sym(self, "input", dtype="f", varying=varying, value=name)

    def row(self, name: str) -> Sym:
        """The env's row of floats in global memory, named ``name`` in C."""
        return Sym(self, "input", dtype="p", varying=False, value=name)

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
        # checked before the memo, which may hold the same node from the body
        scope = max((a.scope for a in args), key=_depth)
        if scope is not None and scope not in self._loops:
            raise ValueError("a value computed inside a repeat body is used after the loop")
        key = (kind,) + tuple(a.id for a in args)
        node = self._memo.get(key)
        if node is None:
            if kind == "select":
                dtype = args[1].dtype
            else:
                dtype = "b" if kind in _BOOL_RESULT else "f"
            node = self._memo[key] = Sym(
                self, kind, args, dtype=dtype, varying=any(a.varying for a in args), scope=scope
            )
        return node

    def _part(self, node: Sym, index: int, kind: str = "part") -> Sym:
        """Result ``index`` of a node with several (a sincos, a loop)."""
        key = (kind, node.id, index)
        part = self._memo.get(key)
        if part is None:
            dtype = node.value.carries[index].dtype if kind == "loopout" else "f"
            part = self._memo[key] = Sym(
                self, kind, (node,), dtype=dtype, varying=node.varying, value=index,
                scope=node.scope,
            )
        return part

    def sincos(self, x):
        """``(sin(x), cos(x))`` from one ``sincosf`` call."""
        node = self.op("sincos", x)
        return self._part(node, 0), self._part(node, 1)

    def repeat(self, n: int, carried, body):
        """``body`` applied ``n`` times to the list ``carried``, as one C loop.

        The body is traced once, on fresh loop-carried values; it must return
        as many values, of the same types, and no value computed from the
        carried ones may leave it but through its result. Returns the values
        after the last pass. With ``n`` 0 or 1 there is no loop.
        """
        carried = [c if isinstance(c, Sym) else self.const(c) for c in carried]
        if n < 2:
            return list(body(carried)) if n == 1 else carried
        loop = _Loop(n, self._loops[-1] if self._loops else None)
        loop.carries = [
            Sym(self, "carry", dtype=c.dtype, varying=True, scope=loop) for c in carried
        ]
        self._loops.append(loop)
        try:
            out = list(body(list(loop.carries)))
        finally:
            self._loops.pop()
        out = [o if isinstance(o, Sym) else self.const(o) for o in out]
        if [o.dtype for o in out] != [c.dtype for c in carried]:
            raise ValueError("a repeat body must return one value of each carried type, in order")
        node = Sym(self, "loop", tuple(carried) + tuple(out), dtype=None, varying=True,
                   value=loop, scope=loop.parent)
        return [self._part(node, i, "loopout") for i in range(len(carried))]

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

    def div(self, a, b):
        return self.op("div", a, b)

    def load(self, row, index):
        """``row[(int)index]``: one load from the env's row."""
        return self.op("load", row, index)

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
    if node.kind == "carry":
        return f"c{node.id}"
    if node.kind == "loopout":  # after the loop, its carried variable holds the result
        return _ref(node.args[0].value.carries[node.value])
    if node.kind == "part":
        return f"t{node.args[0].id}{'sc'[node.value]}"
    return f"t{node.id}"


def _ctype(node: Sym) -> str:
    return "bool" if node.dtype == "b" else "float"


def _statement(node: Sym) -> str:
    if node.kind == "sincos":
        s, c, x = f"t{node.id}s", f"t{node.id}c", _ref(node.args[0])
        return f"float {s}, {c}; sincosf({x}, &{s}, &{c});"
    return f"const {_ctype(node)} t{node.id} = {_expression(node)};"


def _expression(node: Sym) -> str:
    """The C expression of a statement node's value."""
    args = [_ref(a) for a in node.args]
    if node.kind in _C_BINARY:
        return f"{args[0]} {_C_BINARY[node.kind]} {args[1]}"
    if node.kind in _C_CALL:
        return f"{_C_CALL[node.kind]}({', '.join(args)})"
    if node.kind == "neg":
        return f"-{args[0]}"
    if node.kind == "select":
        return f"{args[0]} ? {args[1]} : {args[2]}"
    if node.kind == "load":
        return f"{args[0]}[(int){args[1]}]"
    raise ValueError(f"no C form for {node.kind}")


def _live(outputs) -> list[Sym]:
    """The statement and loop nodes the outputs depend on, in creation order."""
    seen, stack = set(), [o for o in outputs if isinstance(o, Sym)]
    while stack:
        node = stack.pop()
        if node.id in seen:
            continue
        seen.add(node.id)
        stack.extend(node.args)
    prog = outputs[0].prog
    return [prog.nodes[i] for i in sorted(seen) if prog.nodes[i].kind not in _NO_STATEMENT]


def emit(nodes, live, indent: str, no_unroll: str) -> list[str]:
    """C lines of ``nodes`` (live nodes outside every loop, in creation
    order): a statement each, and a loop node as its carried variables, then
    ``no_unroll`` and a ``for`` loop over the live nodes of its body, each
    body indented two more spaces."""
    body_of: dict = {}
    for node in live:
        if node.scope is not None:
            body_of.setdefault(node.scope, []).append(node)

    def block(block_nodes, ind):
        lines = []
        for node in block_nodes:
            if node.kind != "loop":
                lines.append(ind + _statement(node))
                continue
            loop, k = node.value, len(node.value.carries)
            inits, outs = node.args[:k], node.args[k:]
            carries, inner = loop.carries, ind + "  "
            lines += [f"{ind}{_ctype(c)} {_ref(c)} = {_ref(i)};" for c, i in zip(carries, inits)]
            lines += [ind + no_unroll, f"{ind}for (int it = 0; it < {loop.n}; ++it) {{"]
            lines += block(body_of.get(loop, []), inner)
            lines += [
                f"{inner}const {_ctype(c)} n{_ref(c)} = {_ref(o)};" for c, o in zip(carries, outs)
            ]
            lines += [f"{inner}{_ref(c)} = n{_ref(c)};" for c in carries]
            lines.append(f"{ind}}}")
        return lines

    return block(nodes, indent)


def op_counts(nodes) -> dict:
    """Operations the ``nodes`` run, by kind: a node in a loop body once a
    pass, a ``sincos`` as one ``sin`` and one ``cos``."""
    counts: dict = {}
    for node in nodes:
        if node.kind == "loop":
            continue
        trips = node.scope.trips() if node.scope is not None else 1
        for kind in ("sin", "cos") if node.kind == "sincos" else (node.kind,):
            counts[kind] = counts.get(kind, 0) + trips
    return counts


@dataclasses.dataclass(frozen=True)
class GeneratedSource:
    """An emitted kernel source and the count of each kind of operation it
    runs: once a call (the prologue) and in each pass of its substep loop."""

    name: str
    substeps: int  # passes of the substep loop a call (an articulated step's frame_skip)
    text: str
    prologue_ops: dict  # kind -> count, run once a call
    substep_ops: dict  # kind -> count, run `substeps` times a call
    layout: dict | None = None  # how the kernel lays the work over threads, where the generator says

    @property
    def ops_per_env(self) -> int:
        """Operations one env's call runs: the prologue plus every substep."""
        return sum(self.prologue_ops.values()) + self.substeps * sum(self.substep_ops.values())
