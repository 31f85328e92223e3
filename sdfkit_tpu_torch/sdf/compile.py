"""The scene compiler: an SDF expression tree as a straight-line program.

This replaces what JAX tracing did for the Pallas kernels (JAX traced the
tree, callbacks included, into the kernel body, and ``_rebuild`` refilled the
parameters from SMEM scalars). Here:

* :func:`trace` runs ``expr.eval`` on symbolic values (:class:`ops.Sym`) and
  records an SSA program. Each parameter scalar gets a slot in one flat
  float32 buffer, laid out in ``leaves(expr)`` order (:func:`flat_params`).
  Constants fold in float32; identical nodes are shared.
* Dead code is removed separately for the distance output (the march and
  the normal taps need only that) and for the colour-plus-distance outputs.
* :func:`run` executes the program as torch ops (the CPU executor).
* :func:`emit_cpp` writes the program as two C++ functions, ``sdf_dist`` and
  ``sdf_eval``, for the hand-written kernel template in ``csrc/``.
* The adjoint replaces the ``jax.vjp`` the Pallas backward kernel ran on the
  traced body: a reverse sweep over the same program, with the per-op rules
  of ``jax.vjp`` and torch autograd (one rule table, :func:`_pullback`).
  :func:`run_vjp` executes it as torch ops and :func:`emit_vjp_cpp` writes it
  for the backward kernel: ``sdf_eval_vjp``, seeded with the cotangents of
  colour and distance, and ``sdf_dist_unit``, the distance's adjoint for a
  cotangent of one (:func:`run_unit` as torch ops). The adjoint is linear in
  its seed, so the kernel scales the unit form by whatever cotangent a march
  step or a normal tap carries, and evaluations that share no seed do not
  wait for one another.

The program is cached by the tree's structure (node types, callbacks, flags
and parameter shapes), and its hash is that of the emitted source, which
holds parameter slots and never parameter values: editing a value changes
nothing here and rebuilds nothing. A callback that closes over a Python
value is structure, as it was for the JAX package's ``jit``. The adjoint's
source and hash are fields of their own, so a scene that is only rendered
never pays for the backward's build.
"""

from __future__ import annotations

import dataclasses
import hashlib
import math

import numpy as np
import torch
from torch import nn

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.ops import Graph, SymTable, UnsupportedOpError
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device
from sdfkit_tpu_torch.utils.v3 import V3


@dataclasses.dataclass(frozen=True)
class Program:
    nodes: tuple
    is_bool: tuple
    dist: int
    color: tuple  # (r, g, b) node ids
    n_params: int
    dist_live: tuple  # node ids the distance needs, in order
    eval_live: tuple  # node ids colour + distance need, in order
    source: str  # the C++ of sdf_dist and sdf_eval
    hash: str
    adjoint_source: str = ""  # the C++ of sdf_dist_unit and sdf_eval_vjp
    adjoint_hash: str = ""


def _deps(node: tuple) -> tuple:
    op = node[0]
    if op in ("const", "input", "param"):
        return ()
    if op == "gather":
        return (node[4],)
    return node[1:]


def _live(nodes, roots) -> tuple:
    seen = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            stack.extend(_deps(nodes[i]))
    return tuple(sorted(seen))  # ids are created in topological order


def _symbolic(node: SdfExpr, g: Graph, slot: int):
    """A copy of ``node`` whose parameters are symbolic slot loads (and
    whose children are such copies), walked in ``leaves`` order."""
    clone = object.__new__(type(node))
    clone.__dict__.update(node.__dict__)
    clone.__dict__.update(_parameters={}, _modules={}, _buffers={})

    def sym_param(p, slot):
        if p.ndim == 0:
            return g.param(slot), slot + 1
        return SymTable(g, slot, tuple(p.shape)), slot + p.numel()

    for name in node.fields:
        v = getattr(node, name)
        if isinstance(v, SdfExpr):
            sym, slot = _symbolic(v, g, slot)
        elif isinstance(v, nn.ParameterList):
            items = []
            for p in v:
                s, slot = sym_param(p, slot)
                items.append(s)
            sym = tuple(items)
        else:
            sym, slot = sym_param(v, slot)
        clone.__dict__[name] = sym
    return clone, slot


def trace(expr: SdfExpr) -> Program:
    """Trace ``expr.eval`` into a :class:`Program` (uncached)."""
    g = Graph()
    p = V3(g.input(0), g.input(1), g.input(2))
    clone, n_params = _symbolic(expr, g, 0)
    color, dist = clone.eval(p)
    dist = g.lift(dist)
    color = tuple(g.lift(c) for c in (color.x, color.y, color.z))
    for s in (dist, *color):
        if g.is_bool[s.id]:
            raise UnsupportedOpError("a scene output is a comparison, not a float")
    nodes, is_bool = tuple(g.nodes), tuple(g.is_bool)
    dist_live = _live(nodes, [dist.id])
    eval_live = _live(nodes, [dist.id, *(c.id for c in color)])
    prog = Program(
        nodes=nodes, is_bool=is_bool, dist=dist.id, color=tuple(c.id for c in color),
        n_params=n_params, dist_live=dist_live, eval_live=eval_live,
        source="", hash="",
    )
    source = emit_cpp(prog)
    adjoint = emit_vjp_cpp(prog)
    return dataclasses.replace(
        prog, source=source, hash=hashlib.sha256(source.encode()).hexdigest()[:16],
        adjoint_source=adjoint,
        adjoint_hash=hashlib.sha256((source + adjoint).encode()).hexdigest()[:16],
    )


def _structure(node: SdfExpr) -> tuple:
    parts = [type(node)]
    parts.extend(getattr(node, name) for name in node.statics)
    for name in node.fields:
        v = getattr(node, name)
        if isinstance(v, SdfExpr):
            parts.append(_structure(v))
        elif isinstance(v, nn.ParameterList):
            parts.append(tuple(tuple(p.shape) for p in v))
        else:
            parts.append(tuple(v.shape))
    return tuple(parts)


_PROGRAMS: dict[tuple, Program] = {}


def compile_scene(expr: SdfExpr) -> Program:
    """The scene's program, traced once per structure."""
    key = _structure(expr)
    prog = _PROGRAMS.get(key)
    if prog is None:
        prog = _PROGRAMS[key] = trace(expr)
    return prog


def flat_params(expr: SdfExpr) -> torch.Tensor:
    """All parameters as one contiguous float32 vector, in slot order
    (differentiable: a torch.cat of the leaves)."""
    ls = leaves(expr)
    if not ls:
        return torch.zeros(0, dtype=torch.float32, device=scene_device(expr))
    return torch.cat([leaf.reshape(-1) for leaf in ls])


# ---------------------------------------------------------------------------
# The CPU executor.
# ---------------------------------------------------------------------------

_BINARY = {
    "add": lambda a, b: a + b,
    "sub": lambda a, b: a - b,
    "mul": lambda a, b: a * b,
    "div": lambda a, b: a / b,
    "min": ops.minimum,
    "max": ops.maximum,
    "lt": lambda a, b: a < b,
    "le": lambda a, b: a <= b,
    "gt": lambda a, b: a > b,
    "ge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}
_UNARY = {
    "neg": lambda a: -a,
    "abs": ops.abs,
    "floor": ops.floor,
    "sqrt": ops.sqrt,
    "sin": ops.sin,
    "cos": ops.cos,
}


def _forward(program: Program, live, p: V3, params: torch.Tensor) -> dict:
    """The value of every node of ``live`` at the points ``p``."""
    vals = {}
    for i in live:
        node = program.nodes[i]
        op = node[0]
        if op == "const":
            vals[i] = bool(node[1]) if program.is_bool[i] else node[1]
        elif op == "input":
            vals[i] = (p.x, p.y, p.z)[node[1]]
        elif op == "param":
            vals[i] = params[node[1]]
        elif op == "gather":
            _, base, rows, channel, pos = node
            table = params[base : base + 3 * rows].reshape(rows, 3)
            vals[i] = ops.take_rows(table, vals[pos])[channel]
        elif op == "where":
            vals[i] = ops.where(*(vals[a] for a in node[1:]))
        elif op in _UNARY:
            vals[i] = _UNARY[op](vals[node[1]])
        else:
            vals[i] = _BINARY[op](vals[node[1]], vals[node[2]])
    return vals


def run(program: Program, p: V3, params: torch.Tensor, want_color: bool = True):
    """Execute the program on tensors: returns (color V3, dist), or
    (None, dist) with ``want_color=False``. Constant outputs come back as
    Python floats."""
    vals = _forward(program, program.eval_live if want_color else program.dist_live, p, params)
    dist = vals[program.dist]
    if not want_color:
        return None, dist
    return V3(*(vals[c] for c in program.color)), dist


# ---------------------------------------------------------------------------
# The adjoint: one rule table, three back ends (torch values, C++ text, a count).
# ---------------------------------------------------------------------------


def _pullback(op: str, g, out, args, be, want):
    """The cotangent of each argument of ``out = op(*args)`` given the
    cotangent ``g`` of ``out``; None where nothing flows (``floor``, the
    comparisons, a condition) or where ``want`` says that the argument takes
    none (a constant). ``be`` builds the expressions. The rules are those of
    ``jax.vjp`` and torch autograd: ``min``/``max`` halve the cotangent on a
    tie, ``abs`` gives 0 at 0, and ``where`` selects the cotangent (never
    multiplies the other branch's partial by zero, which is what keeps
    ``zero_safe_length`` finite). Where both sides of a ``min``/``max`` take
    a cotangent the second gets ``g`` less the first's, which is the same
    float in all three cases at a third of the operations."""
    if op == "add":
        return g, g
    if op == "sub":
        return g, be.neg(g) if want[1] else None
    if op == "mul":
        return (be.mul(g, args[1]) if want[0] else None,
                be.mul(g, args[0]) if want[1] else None)
    if op == "div":
        q = be.div(g, args[1])
        return q, be.neg(be.mul(q, out)) if want[1] else None
    if op in ("min", "max"):
        first, second = (be.lt, be.gt) if op == "min" else (be.gt, be.lt)
        half = be.mul(0.5, g)

        def side(a, b):
            return be.select(first(a, b), g, be.select(second(a, b), 0.0, half))

        a, b = args
        if want[0] and want[1]:
            ga = be.let(side(a, b))
            return ga, be.sub(g, ga)
        return side(a, b) if want[0] else None, side(b, a) if want[1] else None
    if op == "neg":
        return (be.neg(g),)
    if op == "abs":
        a = args[0]
        return (be.select(be.gt(a, 0.0), g, be.select(be.lt(a, 0.0), be.neg(g), 0.0)),)
    if op == "sqrt":
        return (be.div(g, be.mul(2.0, out)),)
    if op == "sin":
        return (be.mul(g, be.cos(args[0])),)
    if op == "cos":
        return (be.neg(be.mul(g, be.sin(args[0]))),)
    if op == "where":
        return (None, be.select(args[0], g, 0.0) if want[1] else None,
                be.select(args[0], 0.0, g) if want[2] else None)
    return (None,) * len(args)  # floor and the comparisons


class _Folding:
    """The arithmetic of a :func:`_pullback` back end with literals folded:
    a unit seed is the Python float 1.0, and ``1 * x``, ``-1 * x`` and
    arithmetic on two literals must cost no operation. Subclasses give
    ``_neg``, ``_mul``, ``_div`` and ``_sub`` on their own values. ``let``
    names a value that two expressions use (only text needs to)."""

    def let(self, a):
        return a

    def neg(self, a):
        return -a if isinstance(a, float) else self._neg(a)

    def mul(self, a, b):
        if isinstance(a, float) and isinstance(b, float):
            return float(np.float32(a) * np.float32(b))
        for x, y in ((a, b), (b, a)):
            if isinstance(x, float) and x == 1.0:
                return y
            if isinstance(x, float) and x == -1.0:
                return self.neg(y)
        return self._mul(a, b)

    def div(self, a, b):
        if isinstance(a, float) and isinstance(b, float):
            return float(np.float32(a) / np.float32(b))
        return self._div(a, b)

    def sub(self, a, b):
        if isinstance(a, float) and isinstance(b, float):
            return float(np.float32(a) - np.float32(b))
        return self._sub(a, b)


class _TorchOps(_Folding):
    """:func:`_pullback` on tensors (and the Python floats of constants)."""

    _neg = staticmethod(lambda a: -a)
    _mul = staticmethod(lambda a, b: a * b)
    _div = staticmethod(lambda a, b: a / b)
    _sub = staticmethod(lambda a, b: a - b)
    lt = staticmethod(lambda a, b: a < b)
    gt = staticmethod(lambda a, b: a > b)
    sin = staticmethod(ops.sin)
    cos = staticmethod(ops.cos)
    select = staticmethod(ops.where)


def _s(v) -> str:
    return v if isinstance(v, str) else _literal(v)


class _CppOps(_Folding):
    """:func:`_pullback` as C++ expressions over the emitted names; ``let``
    appends a line to ``lines``."""

    def __init__(self, lines: list):
        self.lines = lines

    def let(self, a):
        self.lines.append(f"const float t{len(self.lines)} = {_s(a)};")
        return f"t{len(self.lines) - 1}"

    _neg = staticmethod(lambda a: f"(-{a})")
    _mul = staticmethod(lambda a, b: f"({_s(a)} * {_s(b)})")
    _div = staticmethod(lambda a, b: f"({_s(a)} / {_s(b)})")
    _sub = staticmethod(lambda a, b: f"({_s(a)} - {_s(b)})")
    lt = staticmethod(lambda a, b: f"({_s(a)} < {_s(b)})")
    gt = staticmethod(lambda a, b: f"({_s(a)} > {_s(b)})")
    sin = staticmethod(lambda a: f"sinf({_s(a)})")
    cos = staticmethod(lambda a: f"cosf({_s(a)})")
    select = staticmethod(lambda m, a, b: f"({m} ? {_s(a)} : {_s(b)})")


class _CountOps(_Folding):
    """:func:`_pullback` with every expression counted as one operation.
    Values are the placeholder ``"x"``; only literals are floats."""

    def __init__(self):
        self.n = 0

    def _one(self, *_):
        self.n += 1
        return "x"

    _neg = _mul = _div = _sub = lt = gt = sin = cos = select = _one


# Nodes that pass no cotangent on: none is accumulated for them.
_NO_COTANGENT = frozenset(("const", "floor")) | ops._BOOL_OPS


def _reverse(program: Program, live, seeds, values, be, add, leaf):
    """The reverse sweep over ``live``. ``seeds`` are (node id, cotangent)
    pairs of the outputs, ``values[i]`` is node i's forward value, ``add(i,
    g)`` accumulates a cotangent on node i and returns the running total's
    handle, and ``leaf(i, node, total)`` receives the total of an input, a
    parameter or a gather. Nodes that no cotangent reaches are skipped, so
    the index arithmetic of a repetition costs nothing here."""
    totals = {}
    for i, g in seeds:
        totals[i] = add(i, g)
    for i in reversed(live):
        if i not in totals:
            continue
        node = program.nodes[i]
        op = node[0]
        if op == "const":
            continue
        if op in ("input", "param", "gather"):
            leaf(i, node, totals[i])
            continue
        deps = node[1:]
        args = [values[j] for j in deps]
        want = [program.nodes[j][0] not in _NO_COTANGENT for j in deps]
        if op == "mul" and deps[0] == deps[1]:
            # A square: g*a + g*a and 2*(g*a) are the same float.
            pulled = (be.mul(2.0, be.mul(totals[i], args[0])), None)
        else:
            pulled = _pullback(op, totals[i], values[i], args, be, want)
        for j, gj, wanted in zip(deps, pulled, want):
            if wanted and gj is not None:
                totals[j] = add(j, gj)


def _gather_slots(node, values, shape):
    """Per point, the flat parameter slot a gather read and whether it read
    one: (slot, hit), both flattened to the points."""
    _, base, rows, channel, pos = node
    k = values[pos]
    valid = (k >= 0) & (k < rows) & (k == torch.floor(k))
    slot = base + 3 * torch.where(valid, k, torch.zeros_like(k)).long() + channel
    return (torch.broadcast_to(slot, shape).reshape(-1),
            torch.broadcast_to(valid, shape).reshape(-1))


def _run_reverse(program: Program, live, p: V3, params: torch.Tensor, seeds, param_leaf):
    """The reverse sweep as torch ops: returns the points' cotangent.
    ``seeds`` are the (node id, cotangent) pairs of the outputs, and
    ``param_leaf(node, values, total)`` receives the total of a parameter or
    a gather, broadcast to the points' shape."""
    with torch.no_grad():
        x = torch.broadcast_tensors(p.x, p.y, p.z)
        values = _forward(program, live, V3(*x), params)
        zero = torch.zeros_like(x[0])
        gp = [zero, zero, zero]
        totals = {}

        def add(i, g):
            g = torch.broadcast_to(torch.as_tensor(g, dtype=zero.dtype, device=zero.device),
                                   zero.shape)
            totals[i] = totals[i] + g if i in totals else g
            return totals[i]

        def leaf(i, node, total):
            if node[0] == "input":
                gp[node[1]] = total
            else:
                param_leaf(node, values, total)

        _reverse(program, live, seeds, values, _TorchOps(), add, leaf)
    return V3(*gp)


def run_vjp(program: Program, p: V3, params: torch.Tensor, cotangents,
            want_color: bool = True):
    """The program's adjoint as torch ops, the counterpart of :func:`run`.

    ``cotangents`` is the distance's cotangent, or ``(gr, gg, gb, gd)`` with
    ``want_color``; each has the points' shape. Returns ``(gp, gparams)``:
    the cotangent of the points as a V3 and of the flat parameter buffer,
    summed over the points."""
    live = program.eval_live if want_color else program.dist_live
    gparams = torch.zeros_like(params)

    def param_leaf(node, values, total):
        if node[0] == "param":
            gparams[node[1]] += total.sum()
        else:
            slot, hit = _gather_slots(node, values, total.shape)
            gparams.index_add_(0, slot, torch.where(hit, total.reshape(-1), 0.0))

    if want_color:
        gr, gg, gb, gd = cotangents
        seeds = [*zip(program.color, (gr, gg, gb)), (program.dist, gd)]
    else:
        seeds = [(program.dist, cotangents)]
    return _run_reverse(program, live, p, params, seeds, param_leaf), gparams


def run_unit(program: Program, p: V3, params: torch.Tensor):
    """The distance's adjoint for a cotangent of one at every point, as torch
    ops: the plain version of the emitted ``sdf_dist_unit``. Returns ``(u,
    uparams)``: the distance's gradient in the point as a V3, and in the flat
    parameter buffer as ``(n_params, *points)``, one column per point and not
    summed. ``run_vjp(..., g, want_color=False)`` is ``g * u`` and the sum
    over the points of ``g * uparams``."""
    shape = torch.broadcast_shapes(p.x.shape, p.y.shape, p.z.shape)
    uparams = torch.zeros((params.numel(), math.prod(shape)), dtype=params.dtype,
                          device=params.device)

    def param_leaf(node, values, total):
        if node[0] == "param":
            uparams[node[1]] += total.reshape(-1)
        else:
            slot, hit = _gather_slots(node, values, total.shape)
            points = torch.arange(slot.numel(), device=slot.device)
            uparams.index_put_((slot, points), torch.where(hit, total.reshape(-1), 0.0),
                               accumulate=True)

    u = _run_reverse(program, program.dist_live, p, params, [(program.dist, 1.0)], param_leaf)
    return u, uparams.reshape(params.numel(), *shape)


def operation_counts(program: Program) -> dict:
    """Scalar operations of one call of each emitted function, for a bound on
    the kernels' work: one per arithmetic node (a division, a square root, a
    select or a palette load counts as one), and for an adjoint its forward
    recompute plus every expression and accumulation of its reverse sweep.
    ``dist_unit`` is ``sdf_dist_unit`` with one accumulation per parameter
    slot it reaches (``dist_slots`` of them, ``SDF_N_DIST_SLOTS`` in the
    emitted source). These are nodes of the program, not instructions: the
    card executes several for an IEEE division or square root (``PERF.md`` has
    the measured ratio)."""
    def forward(live):
        return sum(program.nodes[i][0] not in ("const", "input", "param") for i in live)

    def reverse(live, seeds):
        """(operations, parameter slots reached) of one reverse sweep."""
        be = _CountOps()
        seen = set()
        slots = set()

        def add(i, g):
            be.n += i in seen
            seen.add(i)
            return "x"

        def leaf(i, node, total):
            if node[0] == "input":
                be.n += 3
            elif node[0] == "param":
                be.n += 1
                slots.add(node[1])
            else:
                _, base, rows, channel, _ = node
                be.n += 2 * rows
                slots.update(base + 3 * t + channel for t in range(rows))

        _reverse(program, live, seeds, dict.fromkeys(live, "x"), be, add, leaf)
        return be.n, slots

    dist, both = forward(program.dist_live), forward(program.eval_live)
    eval_vjp, _ = reverse(program.eval_live, [(r, "x") for r in (*program.color, program.dist)])
    dist_unit, slots = reverse(program.dist_live, [(program.dist, 1.0)])
    return {"dist": dist, "eval": both, "dist_unit": dist + dist_unit,
            "eval_vjp": both + eval_vjp, "dist_slots": len(slots)}


# ---------------------------------------------------------------------------
# The C++ emitter.
# ---------------------------------------------------------------------------

_CPP_BINARY = {"add": "+", "sub": "-", "mul": "*", "div": "/",
               "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}
_CPP_CALL = {"abs": "fabsf", "floor": "floorf", "sqrt": "sqrtf", "sin": "sinf",
             "cos": "cosf", "min": "fminf", "max": "fmaxf"}


def _literal(v: float) -> str:
    if not math.isfinite(v):
        raise UnsupportedOpError(f"the scene holds a non-finite constant {v}")
    return f"{np.float32(v):.9e}f"


def _uniform(program: Program, live) -> set:
    """The nodes of ``live`` that do not depend on the point: parameters,
    constants and what is computed from them alone. They are the same for
    every evaluation of a launch."""
    uniform = set()
    for i in live:
        node = program.nodes[i]
        if node[0] in ("const", "param") or (
                node[0] not in ("input", "gather") and all(j in uniform for j in node[1:])):
            uniform.add(i)
    return uniform


def _emit_body(program: Program, live, keep_rows: bool = False) -> tuple[list[str], dict]:
    """The forward lines of ``live`` and each node's C++ name. With
    ``keep_rows`` a gather also leaves its palette row in ``k<id>`` (-1 for
    no row), which the adjoint reads.

    A division by a uniform value ``c`` (the cell size of a repetition, under
    a ``floor``) is written as the tail of the IEEE division with the
    reciprocal taken first: ``rc = 1 / c`` correctly rounded, ``q = x * rc``,
    ``r = fma(-c, q, x)``, ``fma(r, rc, q)``. The reciprocal depends on ``c``
    alone, so the compiler lifts it out of a march loop, where the full
    division (a reciprocal seed, two Newton steps and a range check) was paid
    once per evaluation. This is not ``x / c`` for every pair: it is measured
    equal to it where the quotient is a normal number (four million seeded
    pairs and the neighbourhood of every cell border of the scenes' cell
    sizes, ``tests/test_torch_kernel_host.py``), no theorem says so, and it
    has none of the division's range checks. A subnormal quotient may be one
    subnormal step off (``-2**-149 / 1.75`` gives -0, whose floor is 0 and not
    -1: the floor-mod returns the other end of the same cell), and a ``c`` of
    zero, infinity or a subnormal gives NaN where the division gives infinity
    or zero."""
    names = {}
    lines = []
    uniform = _uniform(program, live)
    reciprocals = set()
    for i in live:
        node = program.nodes[i]
        op = node[0]
        if op == "const":
            names[i] = ("true" if node[1] else "false") if program.is_bool[i] else _literal(node[1])
            continue
        if op == "input":
            names[i] = ("px", "py", "pz")[node[1]]
            continue
        v = names[i] = f"v{i}"
        a = [names[j] for j in _deps(node)]
        if op == "param":
            lines.append(f"const float {v} = P[{node[1]}];")
        elif op == "gather":
            _, base, rows, channel, _ = node
            # Row pos of the palette, 0 unless pos is an integer in [0, rows).
            lines.append(f"float {v} = 0.0f;")
            if keep_rows:
                lines.append(f"int k{i} = -1;")
                lines.append(
                    f"if ({a[0]} >= 0.0f && {a[0]} < {float(rows):.1f}f) {{ "
                    f"const int k = (int){a[0]}; "
                    f"if ((float)k == {a[0]}) {{ k{i} = k; {v} = P[{base} + 3 * k + {channel}]; }} }}"
                )
                continue
            lines.append(
                f"if ({a[0]} >= 0.0f && {a[0]} < {float(rows):.1f}f) {{ "
                f"const int k{i} = (int){a[0]}; "
                f"if ((float)k{i} == {a[0]}) {v} = P[{base} + 3 * k{i} + {channel}]; }}"
            )
        elif op == "where":
            lines.append(f"const float {v} = {a[0]} ? {a[1]} : {a[2]};")
        elif op == "neg":
            lines.append(f"const float {v} = -{a[0]};")
        elif op in _CPP_CALL:
            lines.append(f"const float {v} = {_CPP_CALL[op]}({', '.join(a)});")
        elif op == "div" and node[2] in uniform and node[1] not in uniform:
            c = node[2]
            if c not in reciprocals:
                reciprocals.add(c)
                lines.append(f"const float rc{c} = 1.0f / {a[1]};")
            lines.append(f"const float q{i} = {a[0]} * rc{c};")
            lines.append(f"const float {v} = fmaf(fmaf(-{a[1]}, q{i}, {a[0]}), rc{c}, q{i});")
        else:
            ty = "bool" if program.is_bool[i] else "float"
            lines.append(f"const {ty} {v} = {a[0]} {_CPP_BINARY[op]} {a[1]};")
    return lines, names


def emit_cpp(program: Program) -> str:
    """``sdf_dist`` (distance only) and ``sdf_eval`` (colour and distance)
    as C++ for host and device; parameters are read as ``P[slot]``."""
    head = "__host__ __device__ __forceinline__ float"
    dist_lines, dist_names = _emit_body(program, program.dist_live)
    eval_lines, eval_names = _emit_body(program, program.eval_live)
    r, g, b = (eval_names[c] for c in program.color)
    out = [
        "// Scene program emitted by sdfkit_tpu_torch.sdf.compile.",
        f"// {program.n_params} parameter slots; {len(program.dist_live)} "
        f"distance nodes, {len(program.eval_live)} colour+distance nodes.",
        f"{head} sdf_dist(float px, float py, float pz, const float* __restrict__ P) {{",
        *(f"  {ln}" for ln in dist_lines),
        f"  return {dist_names[program.dist]};",
        "}",
        "",
        f"{head} sdf_eval(float px, float py, float pz, const float* __restrict__ P,",
        "                 float* __restrict__ r, float* __restrict__ g, float* __restrict__ b) {",
        *(f"  {ln}" for ln in eval_lines),
        f"  *r = {r};",
        f"  *g = {g};",
        f"  *b = {b};",
        f"  return {eval_names[program.dist]};",
        "}",
        "",
    ]
    return "\n".join(out)


# Palettes of at most this many rows take their cotangent as one
# compare-and-add per row and channel, so that every index into the sums is a
# constant and a small scene's sums can stay in registers. A larger palette
# (three slots a row) makes more sums than registers hold anyway, and the
# unrolled form would be a line of C++ per row and channel: its cotangent
# goes to a run-time row instead.
PALETTE_UNROLLED_ROWS = 32


def _emit_reverse(program: Program, live, seeds, param_leaf, indexed_rows=False) -> list[str]:
    """The body of one adjoint function: forward recompute, then the reverse
    sweep. Cotangents are ``a<id>``; the point's go to ``*gpx, *gpy, *gpz``
    and ``param_leaf(lines, slot, expression)`` writes a parameter's. With
    ``indexed_rows`` (the form that adds to ``gP``) a palette of more than
    ``PALETTE_UNROLLED_ROWS`` rows adds to its run-time row."""
    lines, names = _emit_body(program, live, keep_rows=True)
    lines.append("float gx = 0.0f, gy = 0.0f, gz = 0.0f;")
    declared = set()

    def add(i, g):
        if i in declared:
            lines.append(f"a{i} += {_s(g)};")
        else:
            declared.add(i)
            lines.append(f"float a{i} = {_s(g)};")
        return f"a{i}"

    def leaf(i, node, total):
        if node[0] == "input":
            lines.append(f"g{'xyz'[node[1]]} = {total};")
        elif node[0] == "param":
            param_leaf(lines, node[1], total)
        else:
            # The one-hot blend's VJP in the JAX package; k<id> is -1 where
            # the gather read no row.
            _, base, rows, channel, _ = node
            if indexed_rows and rows > PALETTE_UNROLLED_ROWS:
                lines.append(f"if (k{i} >= 0) gP[{base} + 3 * k{i} + {channel}] += {total};")
                return
            for t in range(rows):
                param_leaf(lines, base + 3 * t + channel, f"((k{i} == {t}) ? {total} : 0.0f)")

    _reverse(program, live, seeds, names, _CppOps(lines), add, leaf)
    lines += ["*gpx = gx;", "*gpy = gy;", "*gpz = gz;", f"return {names[program.dist]};"]
    return lines


def emit_vjp_cpp(program: Program) -> str:
    """The adjoints as C++ for host and device; each recomputes its forward
    at the point, then runs the reverse sweep in the same straight-line
    function, sets ``*gpx, *gpy, *gpz`` and returns the distance.

    * ``sdf_eval_vjp`` takes the cotangents of colour and distance; the
      point's cotangent is set and the parameters' are added to ``gP[slot]``.
    * ``sdf_dist_unit`` is the distance's adjoint for a cotangent of one: it
      sets the distance's gradient in the point, and in the parameters it
      reaches as ``uP[0..SDF_N_DIST_SLOTS)``, one entry per slot that the
      distance depends on. ``sdf_dist_unit_add(g, uP, gP)`` adds ``g`` times
      those to ``gP[slot]``. The kernels use it wherever the cotangent is a
      scalar that is known late (a march step's, a normal tap's): the unit
      form does not wait for it."""
    head = "__host__ __device__ __forceinline__"
    slots: dict[int, int] = {}  # parameter slot -> its place in uP

    def unit_leaf(lines, slot, total):
        if slot in slots:
            lines.append(f"uP[{slots[slot]}] += {total};")
        else:
            slots[slot] = len(slots)
            lines.append(f"uP[{slots[slot]}] = {total};")

    unit = _emit_reverse(program, program.dist_live, [(program.dist, 1.0)], unit_leaf)
    seeds = [*zip(program.color, ("gr", "gg", "gb")), (program.dist, "gd")]
    both = _emit_reverse(program, program.eval_live, seeds,
                         lambda lines, slot, total: lines.append(f"gP[{slot}] += {total};"),
                         indexed_rows=True)
    out = [
        "// Scene adjoint emitted by sdfkit_tpu_torch.sdf.compile.",
        f"#define SDF_N_PARAMS {program.n_params}",
        f"#define SDF_N_DIST_SLOTS {len(slots)}",
        f"{head} float sdf_dist_unit(float px, float py, float pz, const float* __restrict__ P,",
        "                     float* gpx, float* gpy, float* gpz, float* __restrict__ uP) {",
        *(f"  {ln}" for ln in unit),
        "}",
        "",
        f"{head} void sdf_dist_unit_add(float g, const float* __restrict__ uP,",
        "                     float* __restrict__ gP) {",
        *(f"  gP[{slot}] += g * uP[{k}];" for slot, k in slots.items()),
        "}",
        "",
        f"{head} float sdf_eval_vjp(float px, float py, float pz, const float* __restrict__ P,",
        "                     float gr, float gg, float gb, float gd,",
        "                     float* gpx, float* gpy, float* gpz, float* __restrict__ gP) {",
        *(f"  {ln}" for ln in both),
        "}",
        "",
    ]
    return "\n".join(out)


__all__ = ["Program", "compile_scene", "emit_cpp", "emit_vjp_cpp", "flat_params",
           "operation_counts", "run", "run_unit", "run_vjp", "trace"]
