"""The op namespace that SDF node code and user callbacks are written against.

Every op dispatches on its arguments. On torch tensors (or plain numbers) it
runs the torch op. On a :class:`Sym` -- the scene compiler's symbolic value --
it records one node of a straight-line program in the Sym's :class:`Graph`.
So one ``eval`` serves the plain PyTorch renderer and the compiler that emits
the CUDA kernel's scene body (see ``sdf/compile.py``).

The namespace is deliberately small: ``abs``, ``floor``, ``sqrt``, ``sin``,
``cos``, ``minimum``, ``maximum``, ``clip``, ``where``, ``full_like``,
``zeros_like`` and ``broadcast_to``, plus ``+ - * /``, unary minus and the
comparisons on a Sym. A callback that reaches for anything else (``torch.*``,
``numpy`` ufuncs, Python control flow on a value) makes compilation raise an
:class:`UnsupportedOpError` that names the op. ``take_rows`` is the one
node-side op: the palette lookup of ``RepeatIndexedColor``.
"""

from __future__ import annotations

import numbers
import struct

import numpy as np
import torch

__all__ = [
    "abs",
    "broadcast_to",
    "clip",
    "cos",
    "floor",
    "full_like",
    "maximum",
    "minimum",
    "sin",
    "sqrt",
    "where",
    "zeros_like",
]


class UnsupportedOpError(TypeError):
    """A callback used an op the scene compiler cannot lower."""


# ---------------------------------------------------------------------------
# The symbolic value and the program graph it records into.
# ---------------------------------------------------------------------------

# Folding of constant operands runs in float32, as the torch path computes
# them. sin/cos are not folded: numpy's and the device's libm may differ.
_FOLD = {
    "neg": lambda a: -a,
    "abs": np.abs,
    "floor": np.floor,
    "sqrt": np.sqrt,
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "min": np.minimum,
    "max": np.maximum,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}
_BOOL_OPS = frozenset(("lt", "le", "gt", "ge", "eq", "ne"))


class Graph:
    """An SSA program under construction.

    ``nodes[i]`` is ``(op, *args)``; an arg is a node id, except for
    ``const`` (a float32 value), ``input`` (0, 1, 2 for x, y, z), ``param``
    (a slot of the flat parameter buffer) and ``gather`` (base slot, row
    count, channel, then the position's node id). Identical nodes are shared
    (hash-consing), so a parameter loaded twice is one node.
    """

    def __init__(self):
        self.nodes: list[tuple] = []
        self.is_bool: list[bool] = []
        self._index: dict[tuple, int] = {}

    def _add(self, node: tuple, is_bool: bool = False) -> "Sym":
        key = node
        if node[0] == "const":  # -0.0 and 0.0 must stay apart
            key = ("const", struct.pack("<f", node[1]), is_bool)
        i = self._index.get(key)
        if i is None:
            i = len(self.nodes)
            self.nodes.append(node)
            self.is_bool.append(is_bool)
            self._index[key] = i
        return Sym(self, i)

    def const(self, value, is_bool: bool = False) -> "Sym":
        return self._add(("const", float(np.float32(value))), is_bool)

    def input(self, axis: int) -> "Sym":
        return self._add(("input", axis))

    def param(self, slot: int) -> "Sym":
        return self._add(("param", slot))

    def lift(self, v) -> "Sym":
        """A Sym from a Sym of this graph or a plain number."""
        if isinstance(v, Sym):
            if v.graph is not self:
                raise UnsupportedOpError("values from two programs were mixed")
            return v
        if isinstance(v, numbers.Real):
            return self.const(v)
        raise UnsupportedOpError(
            f"a callback combined the scene with a {type(v).__name__}; only "
            "numbers, scene values and sdfkit_tpu_torch.ops are supported"
        )

    def _value(self, s: "Sym"):
        node = self.nodes[s.id]
        if node[0] != "const":
            return None
        return np.bool_(node[1]) if self.is_bool[s.id] else np.float32(node[1])

    def op(self, name: str, *args) -> "Sym":
        syms = [self.lift(a) for a in args]
        is_bool = name in _BOOL_OPS
        if name == "where":
            if not self.is_bool[syms[0].id]:
                raise UnsupportedOpError("where() needs a comparison as condition")
            cond = self._value(syms[0])
            if cond is not None:  # a constant condition picks a branch
                return syms[1] if cond else syms[2]
        elif name in _FOLD:
            vals = [self._value(s) for s in syms]
            if all(v is not None for v in vals):
                out = _FOLD[name](*vals)
                return self.const(out, is_bool=is_bool)
        return self._add((name, *(s.id for s in syms)), is_bool)

    def gather(self, base: int, rows: int, channel: int, pos) -> "Sym":
        pos = self.lift(pos)
        return self._add(("gather", base, rows, channel, pos.id))


class Sym:
    """A symbolic float32 (or boolean) value: one node of a :class:`Graph`."""

    __slots__ = ("graph", "id")
    shape = ()

    def __init__(self, graph: Graph, node_id: int):
        self.graph = graph
        self.id = node_id

    def _bin(self, name, other, swap=False):
        g = self.graph
        return g.op(name, other, self) if swap else g.op(name, self, other)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, swap=True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, swap=True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, swap=True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __rtruediv__(self, o):
        return self._bin("div", o, swap=True)

    def __neg__(self):
        return self.graph.op("neg", self)

    def __lt__(self, o):
        return self._bin("lt", o)

    def __le__(self, o):
        return self._bin("le", o)

    def __gt__(self, o):
        return self._bin("gt", o)

    def __ge__(self, o):
        return self._bin("ge", o)

    def __eq__(self, o):  # noqa: D105 -- records a comparison node
        return self._bin("eq", o)

    def __ne__(self, o):
        return self._bin("ne", o)

    __hash__ = None

    def __bool__(self):
        raise UnsupportedOpError(
            "Python control flow on a scene value (if/and/or/not) cannot be "
            "compiled; use sdfkit_tpu_torch.ops.where"
        )

    def __float__(self):
        raise UnsupportedOpError(
            "a scene value was converted to a Python float (math.* or float()); "
            "use sdfkit_tpu_torch.ops"
        )

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        name = getattr(func, "__name__", repr(func))
        raise UnsupportedOpError(
            f"op torch.{name} is not in sdfkit_tpu_torch.ops and cannot be "
            "compiled into the render kernel"
        )

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        raise UnsupportedOpError(
            f"op numpy.{ufunc.__name__} is not in sdfkit_tpu_torch.ops and "
            "cannot be compiled into the render kernel"
        )

    def __repr__(self):
        return f"Sym(v{self.id})"


class SymTable:
    """A symbolic (rows, cols) parameter: element loads come from slots."""

    def __init__(self, graph: Graph, base: int, shape: tuple):
        self.graph = graph
        self.base = base
        self.shape = tuple(shape)

    def __getitem__(self, index):
        if not isinstance(index, tuple):
            index = (index,)
        if len(index) != len(self.shape):
            raise UnsupportedOpError(
                f"parameter of shape {self.shape} indexed with {index!r}"
            )
        flat = 0
        for i, n in zip(index, self.shape):
            if not isinstance(i, int) or not 0 <= i < n:
                raise UnsupportedOpError(
                    f"parameter of shape {self.shape} needs constant indices, "
                    f"got {index!r}"
                )
            flat = flat * n + i
        return self.graph.param(self.base + flat)


# ---------------------------------------------------------------------------
# The ops.
# ---------------------------------------------------------------------------


def _graph_of(*xs) -> Graph | None:
    for x in xs:
        if isinstance(x, Sym):
            return x.graph
    return None


def _tensor(x, like=None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if like is not None:
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return torch.as_tensor(x, dtype=torch.float32)


def _pair(a, b):
    like = a if isinstance(a, torch.Tensor) else b if isinstance(b, torch.Tensor) else None
    return _tensor(a, like), _tensor(b, like)


def _unary(name, fn):
    def op(x):
        if isinstance(x, Sym):
            return x.graph.op(name, x)
        return fn(_tensor(x))

    op.__name__ = name
    return op


abs = _unary("abs", torch.abs)
floor = _unary("floor", torch.floor)
sqrt = _unary("sqrt", torch.sqrt)
sin = _unary("sin", torch.sin)
cos = _unary("cos", torch.cos)


def minimum(a, b):
    g = _graph_of(a, b)
    if g is not None:
        return g.op("min", a, b)
    return torch.minimum(*_pair(a, b))


def maximum(a, b):
    g = _graph_of(a, b)
    if g is not None:
        return g.op("max", a, b)
    return torch.maximum(*_pair(a, b))


def clip(x, lo, hi):
    """``minimum(maximum(x, lo), hi)``, as ``jnp.clip``."""
    return minimum(maximum(x, lo), hi)


def where(cond, a, b):
    g = _graph_of(cond, a, b)
    if g is not None:
        return g.op("where", cond, a, b)
    cond = _tensor(cond)
    like = a if isinstance(a, torch.Tensor) else b if isinstance(b, torch.Tensor) else None
    if like is None:
        like = torch.empty((), dtype=torch.float32, device=cond.device)
    return torch.where(cond, _tensor(a, like), _tensor(b, like))


def full_like(x, value):
    if isinstance(x, Sym):
        return x.graph.const(value)
    return torch.full_like(_tensor(x), float(value))


def zeros_like(x):
    return full_like(x, 0.0)


def broadcast_to(x, shape):
    """Per-pixel values already are per-pixel in the compiled program, so
    on a Sym this is the identity."""
    if isinstance(x, Sym):
        return x
    return torch.broadcast_to(_tensor(x), shape)


def take_rows(table, pos):
    """Row ``pos`` of a (T, 3) palette as three channels, or 0 where ``pos``
    is not an integer in [0, T) -- the semantics of the one-hot blend in the
    JAX package (``pos == t`` selects row t). A gather on tensors; a direct
    load at ``P[base + 3*pos + c]`` in the compiled program."""
    if isinstance(table, SymTable):
        g = table.graph
        return tuple(g.gather(table.base, table.shape[0], c, pos) for c in range(3))
    if isinstance(pos, Sym):
        raise UnsupportedOpError("take_rows on a tensor table with a symbolic index")
    t_count = table.shape[0]
    valid = (pos >= 0) & (pos < t_count) & (pos == torch.floor(pos))
    idx = torch.where(valid, pos, torch.zeros_like(pos)).long()
    rows = table[idx] * valid.unsqueeze(-1).to(table.dtype)
    return rows[..., 0], rows[..., 1], rows[..., 2]
