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
  ``sdf_eval``, for the hand-written kernel template in ``csrc/``. In a
  program of the large tier a union of like children is written as one loop
  over their parameter table (:class:`UnionLoop`): the same values, bit for
  bit, from one child's code; the large tier's adjoints pull it back as a
  loop too (:func:`_emit_loop_vjp`).
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
nothing here and rebuilds nothing. Each tree also keeps its program and
leaves until an edit of a scene's structure (``sdf/expr.py``), so a frame
or fit step on an unchanged tree walks none of it. A callback that closes
over a Python value is structure, as it was for the JAX package's ``jit``.
The adjoint's source and hash are fields of their own, so a scene that is
only rendered never pays for the backward's build.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import math
import threading
import time
import weakref

import numpy as np
import torch
from torch import nn
from torch._utils import _flatten_dense_tensors

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.ops import Graph, Sym, SymTable, UnsupportedOpError
from sdfkit_tpu_torch.sdf import expr as sdf_expr
from sdfkit_tpu_torch.sdf.expr import SdfExpr, Union, leaves, scene_device
from sdfkit_tpu_torch.utils.spans import span
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
    adjoint_source: str = ""  # the C++ of the adjoints (sdf_dist_unit ... or sdf_dist_vjp ...)
    adjoint_hash: str = ""
    large: bool = False  # the backward's large-scene tier (``large_tier``)
    loops: tuple = ()  # the UnionLoops emit_cpp writes as loops (the large tier only)
    # (children, share of dist_live) that those loops cover; (0, 0.0) where none
    looped: tuple = (0, 0.0)


@dataclasses.dataclass(frozen=True)
class UnionLoop:
    """A tree of ``Union`` nodes over ``count`` like children, which
    :func:`emit_cpp` writes as one loop over the children: child ``k`` is
    ``child`` with its slot ``j`` read at ``base + stride * k + j``. ``point``
    holds the node ids of the point the union is evaluated at, ``dist`` and
    ``color`` the ids of its outputs in the traced program, which the loop
    computes in place of the tree's nodes. ``splits`` is the tree's shape,
    which the adjoints' rule for ties follows (:func:`_emit_loop_vjp`): for
    each ``Union`` of the tree in pre-order, the first child of its right
    side."""

    point: tuple
    dist: int
    color: tuple
    count: int
    base: int
    stride: int
    child: Program
    splits: tuple = ()


def _deps(node: tuple) -> tuple:
    op = node[0]
    if op in ("const", "input", "param"):
        return ()
    if op == "gather":
        return (node[4],)
    return node[1:]


def _live(nodes, roots, deps=None) -> tuple:
    """The nodes that ``roots`` need; ``deps`` (node id -> ids) overrides
    what a node needs."""
    deps = deps or {}
    seen = set()
    stack = list(roots)
    while stack:
        i = stack.pop()
        if i not in seen:
            seen.add(i)
            stack.extend(deps[i] if i in deps else _deps(nodes[i]))
    return tuple(sorted(seen))  # ids are created in topological order


def _symbolic(node: SdfExpr, g: Graph, slot: int, loops: list | None = None):
    """A copy of ``node`` whose parameters are symbolic slot loads (and
    whose children are such copies), walked in ``leaves`` order. With
    ``loops``, each union of like children (:func:`_like_children`) appends
    its :class:`UnionLoop` there when it is evaluated."""
    if loops is not None and type(node) is Union:
        children = _union_children(node)
        child = _like_children(children)
        if child is not None:
            return _looped(node, g, slot, loops, len(children), child)
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
            sym, slot = _symbolic(v, g, slot, loops)
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


def _outputs(g: Graph, clone, p: V3) -> tuple:
    """(dist, (r, g, b)) of ``clone`` at ``p`` as Syms of ``g``; raises
    where an output is a comparison."""
    color, dist = clone.eval(p)
    dist = g.lift(dist)
    color = tuple(g.lift(c) for c in (color.x, color.y, color.z))
    for s in (dist, *color):
        if g.is_bool[s.id]:
            raise UnsupportedOpError("a scene output is a comparison, not a float")
    return dist, color


def _program(g: Graph, dist, color, n_params: int) -> Program:
    nodes = tuple(g.nodes)
    return Program(
        nodes=nodes, is_bool=tuple(g.is_bool), dist=dist.id, color=tuple(c.id for c in color),
        n_params=n_params, dist_live=_live(nodes, [dist.id]),
        eval_live=_live(nodes, [dist.id, *(c.id for c in color)]), source="", hash="",
    )


def trace(expr: SdfExpr) -> Program:
    """Trace ``expr.eval`` into a :class:`Program` (uncached)."""
    g = Graph()
    p = V3(g.input(0), g.input(1), g.input(2))
    loops = []
    clone, n_params = _symbolic(expr, g, 0, loops)
    prog = _program(g, *_outputs(g, clone, p), n_params)
    prog = dataclasses.replace(prog, large=large_tier(prog))
    if prog.large:
        prog = _with_loops(prog, loops)
    source = emit_cpp(prog)
    adjoint = emit_vjp_cpp(prog)
    return dataclasses.replace(
        prog, source=source, hash=hashlib.sha256(source.encode()).hexdigest()[:16],
        adjoint_source=adjoint,
        adjoint_hash=hashlib.sha256((source + adjoint).encode()).hexdigest()[:16],
    )


# ---------------------------------------------------------------------------
# Unions of like children, written as loops.
#
# A union of n children that differ only in their parameters (the 200
# translated spheres of scenes.union_grid_scene) is n copies of one child's
# code in the straight-line form: at 200 spheres about 3,000 lines for one
# distance, inlined at every call site of the kernels. The loop form runs
# one child's code n times, reading child k's slot j at base + stride*k + j.
#
# It computes the tree's floats bit for bit wherever no child's distance is
# NaN while another's is not: the distance is fminf of the children's, which
# skips a NaN and, of children whose distances compare equal (+0 and -0
# included), returns the same one however the tree pairs them (of two that
# compare equal fminf returns a fixed side, or treats -0 as the less); the
# colour is the last child's of those whose distance is the least
# (``da < db ? a : b`` at every node of the tree picks that one, however it
# pairs them); and where every distance is NaN both give NaN and the last
# child's colour. A child whose distance alone is NaN (a parameter that is NaN) is
# passed over as the tree's nodes pass it, but the colour then goes by the
# loop's order: the tree's pairing would have to be replayed to follow it.
#
# The large tier's adjoints replay it where it matters: a warp in which a
# point has a tie or a NaN distance walks the tree (UnionLoop.splits) and
# gives each child, colour and distance, the cotangent the tree's selects
# give it (_emit_loop_vjp); only the forward's colour that such an adjoint
# recomputes, which no pullback of a scene here reads, keeps the loop's.
# ---------------------------------------------------------------------------


# The fewest like children a union takes the loop form with. The image
# forward of union_grid_scene(n) on an H100 at 1920x1080x40 (parameters in
# shared memory, tools/torch_kernel_probe.py --loops), loop / straight-line:
# n = 12 0.891 / 0.627 ms, 16 1.179 / 0.860, 24 1.757 / 1.440, 32 2.323 /
# 2.206, 48 3.459 / 3.966, 64 4.586 / 6.254, 100 7.048 / 11.554, 200 13.777
# / 35.897. A child costs the loop 0.069-0.074 ms at every n; the
# straight-line program's cost per child grows with n, its parameters all
# constant-bank operands.
LOOP_MIN_CHILDREN = 48
# The loop's unroll. At n = 200, unrolled by 2 / not: the image forward 12.703
# / 13.779 ms, the image backward 113.039 / 109.968 (its replay and taps run
# the same loop). A fit step runs both, and the backward is most of it. With
# the adjoints' loops unrolled too (_emit_loop_vjp), the image backward reads
# 45.715 / 48.205 ms: measured alone, not yet as a fit step.
LOOP_UNROLL = 1
# A program with loops has the kernels copy its parameters into shared memory
# once a block and read them there (csrc/raymarch_uniforms.cuh scene_params),
# up to this many slots: 16 KB, which beside the store-fed backward's 24 KB
# ring stays under the 48 KB a block may declare. A larger one reads the
# constant bank (or device memory) as a straight-line program does.
SHARED_PARAMS_MAX_SLOTS = 4096


def _union_children(node: SdfExpr) -> list:
    """The children of the tree of ``Union`` nodes at ``node``, left to
    right (which is their slots' order)."""
    if type(node) is not Union:
        return [node]
    return _union_children(node.a) + _union_children(node.b)


def _union_splits(node: SdfExpr, first: int = 0) -> list:
    """For each ``Union`` of the tree at ``node`` in pre-order, the index of
    the first child of its right side; ``first`` is the index of the tree's
    first child."""
    if type(node) is not Union:
        return []
    mid = first + len(_union_children(node.a))
    return [mid, *_union_splits(node.a, first), *_union_splits(node.b, mid)]


def _slot_table(starts, stride: int) -> int | None:
    """The base of the affine slot table that ``starts`` (each child's first
    slot) is, child ``k`` at ``base + stride * k``; None where it is not."""
    base = starts[0]
    return base if all(s == base + stride * k for k, s in enumerate(starts)) else None


def _like_children(children) -> Program | None:
    """One child's program (:func:`_trace_child`) where there are
    ``LOOP_MIN_CHILDREN`` or more children of one structure (``_structure``),
    their slots an affine table and their programs, each traced with its
    slots from 0, equal; else None."""
    if (len(children) < max(LOOP_MIN_CHILDREN, 2)
            or any(_structure(c) != _structure(children[0]) for c in children)):
        return None
    first = _trace_child(children[0])
    if first is None or first.n_params == 0:
        return None
    starts = [0]
    for c in children[:-1]:
        starts.append(starts[-1] + sum(p.numel() for p in leaves(c)))
    if _slot_table(starts, first.n_params) is None:
        return None
    return first if all(_trace_child(c) == first for c in children[1:]) else None


def _trace_child(expr: SdfExpr) -> Program | None:
    """``expr`` traced alone with its slots from 0, with the unions of like
    children inside it as loops of their own; None where an output is a
    comparison."""
    g = Graph()
    p = V3(g.input(0), g.input(1), g.input(2))
    loops = []
    clone, n_params = _symbolic(expr, g, 0, loops)
    try:
        outputs = _outputs(g, clone, p)
    except UnsupportedOpError:
        return None
    return _with_loops(_program(g, *outputs, n_params), loops)


def _looped(node, g: Graph, slot: int, loops: list, count: int, child: Program):
    """The copy of the union tree ``node`` whose evaluation also appends its
    :class:`UnionLoop` to ``loops``. The children's copies are not searched
    for unions of their own: ``child`` holds those."""
    clone, end = _symbolic(node, g, slot)

    def evaluate(p: V3):
        color, dist = Union.eval(clone, p)
        point, outs = (p.x, p.y, p.z), (dist, color.x, color.y, color.z)
        if all(isinstance(v, Sym) and v.graph is g for v in (*point, *outs)):
            loops.append(UnionLoop(point=tuple(v.id for v in point), dist=dist.id,
                                   color=tuple(v.id for v in outs[1:]), count=count,
                                   base=slot, stride=child.n_params, child=child,
                                   splits=tuple(_union_splits(node))))
        return color, dist

    clone.__dict__["eval"] = evaluate
    return clone, end


def _loop_deps(loops) -> dict:
    """For ``_live``: a loop's outputs need its point alone."""
    return {i: lp.point for lp in loops for i in (lp.dist, *lp.color)}


def _with_loops(program: Program, loops) -> Program:
    """``program`` with the loops of ``loops`` that its outputs need (one
    each: a union evaluated twice at one point is one loop), and their
    cover: the children, and the share of ``dist_live`` that the loops
    compute in place of the straight-line nodes."""
    loops = tuple(lp for lp in {lp.dist: lp for lp in loops}.values()
                  if lp.dist in program.eval_live)
    if not loops:
        return program
    straight = _live(program.nodes, [program.dist], _loop_deps(loops))
    outputs = {lp.dist for lp in loops}
    covered = len(program.dist_live) - sum(i not in outputs for i in straight)
    return dataclasses.replace(program, loops=loops, looped=(
        sum(lp.count for lp in loops), covered / len(program.dist_live)))


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
TRACES = 0  # compile_scene's misses in this process: the scenes traced
LOOPED = 0  # of those, the programs with a union of like children as a loop
LOOPED_ADJOINTS = 0  # of those, the programs whose adjoints pull such a union back as a loop
TRACE_SECONDS = 0.0  # the seconds those traces took
_COUNTS = threading.Lock()


# Each tree's (edit count, program table, program, leaves) as of its last
# walk; a tree's entry goes with the tree.
_SCENES: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _lookup(expr: SdfExpr) -> Program:
    """The program of ``expr``'s structure, traced on a miss."""
    global TRACES, TRACE_SECONDS, LOOPED, LOOPED_ADJOINTS
    key = _structure(expr)
    prog = _PROGRAMS.get(key)
    if prog is None:
        t0 = time.perf_counter()
        with span("sdf.compile"):
            prog = _PROGRAMS[key] = trace(expr)
        with _COUNTS:
            TRACES += 1
            LOOPED += bool(prog.loops)
            LOOPED_ADJOINTS += bool(_adjoint_loops(prog))
            TRACE_SECONDS += time.perf_counter() - t0
    return prog


def _scene(expr: SdfExpr) -> tuple:
    """``(program, leaves)`` of ``expr``, the leaves in slot order. The tree
    is walked again only after an edit of some scene's structure
    (``sdf_expr.EDITS``) or with another program table in place."""
    memo = _SCENES.get(expr)
    if memo is not None and memo[0] == sdf_expr.EDITS and memo[1] is _PROGRAMS:
        return memo[2], memo[3]
    edits, programs = sdf_expr.EDITS, _PROGRAMS  # before the walk: an edit during it misses next
    prog, ls = _lookup(expr), leaves(expr)
    _SCENES[expr] = (edits, programs, prog, ls)
    return prog, ls


def compile_scene(expr: SdfExpr) -> Program:
    """The scene's program, traced once per structure and looked up once
    per tree until a structure is edited (``sdf/expr.py``)."""
    return _scene(expr)[0]


def flat_params(expr: SdfExpr) -> torch.Tensor:
    """All parameters as one contiguous float32 vector, in slot order, read
    from the leaves' current tensors (differentiable: a concatenation of the
    leaves, made in one call)."""
    ls = _scene(expr)[1]
    if not ls:
        return torch.zeros(0, dtype=torch.float32, device=scene_device(expr))
    if len(ls) == 1:  # _flatten_dense_tensors would return a view of the leaf
        return torch.cat([ls[0].reshape(-1)])
    return _flatten_dense_tensors(ls)


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
    emitted source), ``slots_added`` the slots one call adds to. These are
    nodes of the program, not instructions: the card executes several for an
    IEEE division or square root (``PERF.md`` has the measured ratio).

    For a program of the large tier the adjoints count what one evaluation
    needs: the forward and the reverse sweep down the costliest path of the
    regions whose cotangent is not zero (``_emit_gated``), the adds on that
    path as ``slots_added``; ``dist_unit_recompute`` and
    ``eval_vjp_recompute`` are the forward operations those regions redo."""
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
    dist_unit, slots = reverse(program.dist_live, [(program.dist, 1.0)])
    if program.large:
        parts = _large_parts(program)
        d, e = parts["dist"][2], parts["eval"][2]
        return {"dist": dist, "eval": both, "dist_unit": dist + d["reverse"],
                "eval_vjp": both + e["reverse"], "dist_slots": len(slots),
                "slots_added": d["slots_added"], "dist_unit_recompute": d["recompute"],
                "eval_vjp_recompute": e["recompute"]}
    eval_vjp, _ = reverse(program.eval_live, [(r, "x") for r in (*program.color, program.dist)])
    return {"dist": dist, "eval": both, "dist_unit": dist + dist_unit,
            "eval_vjp": both + eval_vjp, "dist_slots": len(slots), "slots_added": len(slots)}


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


def _emit_body(program: Program, live, keep_rows: bool = False, suffix: str = "",
               inputs=("px", "py", "pz"), params: str = "P",
               record=None, loops=(), loop_params: str | None = None,
               track: bool = False) -> tuple[list[str], dict]:
    """The forward lines of ``live`` and each node's C++ name. With
    ``keep_rows`` a gather also leaves its palette row in ``k<id>`` (-1 for
    no row), which the adjoint reads. ``suffix`` ends every name the lines
    declare and ``inputs`` names the point, so that one function can hold
    the forwards of two points; ``params`` names the parameter array, and
    ``record(i, names)`` gives lines to follow node ``i``'s. The outputs of
    ``loops`` are written as those loops (:func:`_emit_loop`), reading
    ``loop_params`` (``params`` where None) and with ``track`` keeping what
    the loop form of the adjoint reads.

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
    loop_of = {i: lp for lp in loops for i in (lp.dist, *lp.color)}
    for i in live:
        node = program.nodes[i]
        op = node[0]
        if i in loop_of:
            if loop_of[i].dist not in names:
                lines += _emit_loop(loop_of[i], names, live, suffix,
                                    params if loop_params is None else loop_params, track)
            continue
        if op == "const":
            names[i] = ("true" if node[1] else "false") if program.is_bool[i] else _literal(node[1])
            continue
        if op == "input":
            names[i] = inputs[node[1]]
            continue
        v = names[i] = f"v{i}{suffix}"
        a = [names[j] for j in _deps(node)]
        if op == "param":
            lines.append(f"const float {v} = {params}[{node[1]}];")
        elif op == "gather":
            _, base, rows, channel, _ = node
            # Row pos of the palette, 0 unless pos is an integer in [0, rows).
            lines.append(f"float {v} = 0.0f;")
            if keep_rows:
                lines.append(f"int k{i}{suffix} = -1;")
                lines.append(
                    f"if ({a[0]} >= 0.0f && {a[0]} < {float(rows):.1f}f) {{ "
                    f"const int k = (int){a[0]}; "
                    f"if ((float)k == {a[0]}) {{ k{i}{suffix} = k; "
                    f"{v} = {params}[{base} + 3 * k + {channel}]; }} }}"
                )
                continue
            lines.append(
                f"if ({a[0]} >= 0.0f && {a[0]} < {float(rows):.1f}f) {{ "
                f"const int k{i} = (int){a[0]}; "
                f"if ((float)k{i} == {a[0]}) {v} = {params}[{base} + 3 * k{i} + {channel}]; }}"
            )
        elif op == "where":
            lines.append(f"const float {v} = {a[0]} ? {a[1]} : {a[2]};")
        elif op == "neg":
            lines.append(f"const float {v} = -{a[0]};")
        elif op in _CPP_CALL:
            lines.append(f"const float {v} = {_CPP_CALL[op]}({', '.join(a)});")
        elif op == "div" and node[2] in uniform and node[1] not in uniform:
            c = node[2]
            rc, q = f"rc{c}{suffix}", f"q{i}{suffix}"
            if c not in reciprocals:
                reciprocals.add(c)
                lines.append(f"const float {rc} = 1.0f / {a[1]};")
            lines.append(f"const float {q} = {a[0]} * {rc};")
            lines.append(f"const float {v} = fmaf(fmaf(-{a[1]}, {q}, {a[0]}), {rc}, {q});")
        else:
            ty = "bool" if program.is_bool[i] else "float"
            lines.append(f"const {ty} {v} = {a[0]} {_CPP_BINARY[op]} {a[1]};")
        if record is not None:
            lines += record(i, names)
    return lines, names


def _emit_program(program: Program, roots, suffix: str = "", inputs=("px", "py", "pz"),
                  params: str = "P") -> tuple[list[str], dict]:
    """The forward lines of what ``roots`` need, the program's loops
    written as loops, and each node's C++ name (``_emit_body``)."""
    live = _live(program.nodes, roots, _loop_deps(program.loops))
    return _emit_body(program, live, suffix=suffix, inputs=inputs, params=params,
                      loops=program.loops)


def _emit_loop(lp: UnionLoop, names: dict, live, suffix: str, params: str,
               track: bool = False) -> list[str]:
    """The lines of the union ``lp``: its first child's distance, then the
    others' in a rolled loop, ``fminf`` of each into the running distance;
    where ``live`` holds the union's colour, the index of the child whose
    colour the tree gives (the last of the least distances: taken where the
    running distance is not less than the child's, so that a NaN distance
    passes the colour on as the tree's selects do), and after the loop that
    child's colour alone. Sets the names of the union's outputs.

    With ``track`` (the adjoints' forward, :func:`_emit_loop_vjp`) the loop
    also keeps that index whatever ``live`` holds, ``tie<tag>``: whether a
    second child's distance equals the least, and ``nan<tag>``: whether some
    child's distance is NaN."""
    tag = f"{lp.dist}{suffix}"
    point = tuple(names[j] for j in lp.point)
    child = lp.child
    want_color = any(c in live for c in lp.color)
    dist, n, won = f"v{tag}", f"n{tag}", f"i{tag}"
    tie, nan = f"tie{tag}", f"nan{tag}"

    def child_at(roots, sfx, table, slot):
        body, cn = _emit_program(child, roots, f"_{sfx}{tag}", point, f"{table}{tag}")
        return [f"const float* __restrict__ {table}{tag} = {params} + ({slot});", *body], cn

    first, cn = child_at([child.dist], "f", "F", lp.base)
    lines = [f"// {lp.count} like children of a union, child {n} reading its slot j at "
             f"{params}[{lp.base} + {lp.stride} * {n} + j].", *first,
             f"float {dist} = {_s(cn[child.dist])};"]
    if want_color or track:
        lines.append(f"int {won} = 0;")
    if track:
        d0 = _s(cn[child.dist])
        lines += [f"bool {tie} = false;", f"bool {nan} = !({d0} == {d0});"]
    body, cn = child_at([child.dist], "", "Q", f"{lp.base} + {lp.stride} * {n}")
    lines += [f"#pragma unroll {LOOP_UNROLL}",
              f"for (int {n} = 1; {n} < {lp.count}; ++{n}) {{", *(f"  {ln}" for ln in body)]
    d = _s(cn[child.dist])
    if track:
        lines += [f"  {nan} = {nan} || !({d} == {d});",
                  f"  {tie} = {d} < {dist} ? false : ({tie} || {d} == {dist});"]
    if want_color or track:
        lines.append(f"  if (!({dist} < {d})) {won} = {n};")
    lines += [f"  {dist} = fminf({dist}, {d});", "}"]
    names[lp.dist] = dist
    if want_color:
        body, cn = child_at(child.color, "w", "W", f"{lp.base} + {lp.stride} * {won}")
        lines += body
        for i, c in zip(lp.color, child.color):
            names[i] = cn[c]
    return lines


def emit_cpp(program: Program) -> str:
    """``sdf_dist`` (distance only) and ``sdf_eval`` (colour and distance)
    as C++ for host and device; parameters are read as ``P[slot]``. The
    program's unions of like children (``Program.loops``) are loops."""
    head = "__host__ __device__ __forceinline__ float"
    dist_lines, dist_names = _emit_program(program, [program.dist])
    eval_lines, eval_names = _emit_program(program, [program.dist, *program.color])
    r, g, b = (eval_names[c] for c in program.color)
    out = [
        "// Scene program emitted by sdfkit_tpu_torch.sdf.compile.",
        f"// {program.n_params} parameter slots; {len(program.dist_live)} "
        f"distance nodes, {len(program.eval_live)} colour+distance nodes.",
        *([f"// Unions of like children as loops: {program.looped[0]} children, "
           f"{program.looped[1]:.4f} of the distance nodes."] if program.loops else []),
        *(["#define SDF_SHARED_PARAMS 1  // csrc/raymarch_uniforms.cuh scene_params"]
          if program.loops and program.n_params <= SHARED_PARAMS_MAX_SLOTS else []),
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
      form does not wait for it.

    A program of the large tier (``Program.large``) gets
    :func:`emit_large_vjp_cpp` instead."""
    if program.large:
        return emit_large_vjp_cpp(program)
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


# ---------------------------------------------------------------------------
# The large-scene tier of the adjoint.
# ---------------------------------------------------------------------------

# The backward's tier (csrc/raymarch_bwd.cuh). A scene of at most this many
# parameter slots takes the small tier: each thread keeps a running sum per
# slot, and the unit form a gradient per slot the distance reads, in arrays
# whose every index is a constant, so that for a small scene they live in
# registers. A larger scene, or one whose distance reads a palette of more
# than PALETTE_UNROLLED_ROWS rows, takes the large tier, which keeps no array
# whose length is a number of slots (emit_large_vjp_cpp). Measured on an H100
# with unions of 4 to 24 spheres at 1920x1080x40, the image backward in the
# small / large tier (tools/torch_kernel_probe.py --tiers): 28 slots 0.451 /
# 0.460 ms, 35 slots 0.567 / 0.528, 42 slots 0.685 / 0.644, 56 slots 0.994 /
# 0.845, 112 slots 2.631 / 2.340, 168 slots 7.804 / 3.770 (PERF.md).
LARGE_SCENE_SLOTS = 32

# The large tier's adjoint skips a subtree whose cotangent is zero for the
# whole warp (the untaken side of a min, a where or an abs): every subtree of
# the reverse sweep that takes its cotangent from selects alone and has at
# least GATE_MIN_NODES nodes gets its own test, down to at most GATE_DEPTH
# tests inside one another (a left-deep chain of unions is tested that far
# along). Neither is tuned on the card: 8 is below the node count of a
# translated sphere (about 10), so that each primitive of a union gets its
# test, and a balanced union is 32 deep only at 2^32 primitives.
GATE_MIN_NODES = 8
GATE_DEPTH = 32

# The nodes whose pullback needs no float value: a select's cotangent goes by
# comparisons alone (their outcomes are kept as bits), a sum's passes as it is.
_SELECTS = ("min", "max", "abs", "where")


def large_tier(program: Program) -> bool:
    """Whether the backward of ``program`` takes the large-scene tier."""
    return program.n_params > LARGE_SCENE_SLOTS or any(
        program.nodes[i][0] == "gather" and program.nodes[i][2] > PALETTE_UNROLLED_ROWS
        for i in program.dist_live)


def _flow(program: Program, live) -> dict:
    """Node -> the nodes of ``live`` that pass it a cotangent (the edges of
    :func:`_reverse`: no cotangent leaves a comparison, a floor, a leaf or a
    where's condition, and none reaches a constant)."""
    consumers = {i: [] for i in live}
    for c in live:
        node = program.nodes[c]
        if node[0] in ("input", "param", "gather") or node[0] in _NO_COTANGENT:
            continue
        for j in dict.fromkeys(node[1:]):  # a square names its operand twice
            if program.nodes[j][0] not in _NO_COTANGENT:
                consumers[j].append(c)
    return consumers


def _gating(program: Program, live, seed_ids, gate_seeds: bool = False) -> dict:
    """The reverse sweep's structure for the large tier: which nodes a
    cotangent reaches from ``seed_ids``, each one's immediate dominator in
    the flow of cotangents (``root``, -1, above the seeds: every path from a
    seed to the node passes its dominator, so the node's cotangent is zero
    where its dominator's is), the gated nodes (whose cotangent a select
    gives: it is often exactly zero; with ``gate_seeds`` a seed is gated as
    if a select gave its cotangent) and each node's level: the nearest gated
    dominator, in whose region the node's cotangent is complete and pulled
    back. A union written as a loop (``loop`` and ``alias`` nodes,
    :func:`_contracted`) is never gated: its pullback reads all its
    outputs' cotangents."""
    consumers = _flow(program, live)
    reached, stack = set(seed_ids), list(seed_ids)
    feeds = {i: [] for i in live}
    for j, cs in consumers.items():
        for c in cs:
            feeds[c].append(j)
    while stack:
        for j in feeds[stack.pop()]:
            if j not in reached:
                reached.add(j)
                stack.append(j)
    root = -1
    idom, depth = {}, {root: 0}

    def common(a, b):
        while a != b:
            if depth[a] < depth[b]:
                a, b = b, a
            a = idom[a]
        return a

    for j in sorted(reached, reverse=True):  # ids are topological: consumers first
        preds = [c for c in consumers[j] if c in reached] + ([root] if j in seed_ids else [])
        d = preds[0]
        for c in preds[1:]:
            d = common(d, c)
        idom[j], depth[j] = d, depth[d] + 1
    size = dict.fromkeys([root, *reached], 1)
    for j in sorted(reached):
        size[idom[j]] += size[j]
    head, nesting, gated = {root: root}, {root: 0}, set()
    for j in sorted(reached, reverse=True):
        parent = head[idom[j]]
        if ((gate_seeds or j not in seed_ids)
                and program.nodes[j][0] not in ("input", "param", "gather", "loop", "alias")
                and size[j] >= GATE_MIN_NODES and nesting[parent] < GATE_DEPTH
                and all(program.nodes[c][0] in _SELECTS for c in consumers[j])):
            gated.add(j)
            head[j], nesting[j] = j, nesting[parent] + 1
        else:
            head[j] = parent
    level = {j: head[idom[j]] for j in reached}
    return {"root": root, "reached": reached, "consumers": consumers, "gated": gated,
            "level": level}


class _NamedOps(_CppOps):
    """:func:`_pullback` as C++ with temporaries named from one counter (the
    large tier's regions are nested scopes), its operations counted in
    ``n``. A comparison found in ``bits`` (keyed by operation and operands)
    is the kept outcome there, not a comparison of values."""

    def __init__(self):
        super().__init__([])
        self.temporaries = 0
        self.n = 0
        self.leaves = 0  # parameter adds
        self.bits = {}

    def let(self, a):
        self.temporaries += 1
        self.lines.append(f"const float t{self.temporaries} = {_s(a)};")
        return f"t{self.temporaries}"

    def lt(self, a, b):
        self.n += 1
        return self.bits.get(("lt", a, b)) or _CppOps.lt(a, b)

    def gt(self, a, b):
        self.n += 1
        return self.bits.get(("gt", a, b)) or _CppOps.gt(a, b)


def _counted(name):
    base = getattr(_CppOps, name)

    def op(self, *args):
        self.n += 1
        return base(*args)

    return op


for _name in ("_neg", "_mul", "_div", "_sub", "sin", "cos", "select"):
    setattr(_NamedOps, _name, _counted(_name))


def _values_needed(program: Program, j: int) -> tuple:
    """The forward values the pullback of node ``j`` reads (a select reads
    its kept comparisons instead, a gather its row)."""
    node = program.nodes[j]
    op = node[0]
    if op == "loop":
        return tuple(node[1:])  # its point: the loop form's pullback reads it
    if op in ("input", "const", "param", "add", "sub", "neg", "alias") or op in _SELECTS:
        return ()
    if op in ("gather", "sqrt"):
        return (j,)
    if op == "div":
        return (node[2], j)
    return tuple(node[1:])  # mul, sin, cos


def _adjoint_loops(program: Program) -> tuple:
    """The loops of ``program`` whose pullback takes the loop form
    (:func:`_emit_loop_vjp`): those whose tree of unions hands its values to
    the rest of the program through its outputs alone. A node of the tree
    that a node outside it reads as well (an expression the scene shares
    with the union's children) would take a cotangent from outside, which
    the loop form does not pull back: the adjoints keep such a union in the
    straight-line form."""
    nodes = program.nodes
    readers = {}
    for c in program.eval_live:
        for j in _deps(nodes[c]):
            readers.setdefault(j, set()).add(c)
    kept = []
    for lp in program.loops:
        outputs = {lp.dist, *lp.color}
        inner = set(_live(nodes, outputs)) - set(_live(nodes, lp.point))
        if all(readers.get(j, set()) <= inner for j in inner - outputs
               if nodes[j][0] != "const"):
            kept.append(lp)
    return tuple(kept)


def _contracted(program: Program, loops, live) -> tuple[Program, dict]:
    """``program`` with each union of ``loops`` as one node of the reverse
    sweep: the output of least id that ``live`` holds becomes ``("loop",
    *point)``, whose pullback is the loop's, and each other output ``("alias",
    that id)``, which gathers its own cotangent for that pullback. Its ids
    stay topological: the union's other outputs, and every node that reads
    one, come after it. Returns the program and that id -> loop."""
    nodes = list(program.nodes)
    heads = {}
    for lp in loops:
        outputs = sorted(i for i in set((lp.dist, *lp.color)) if i in live)
        if not outputs:  # a union the distance does not read
            continue
        nodes[outputs[0]] = ("loop", *lp.point)
        for i in outputs[1:]:
            nodes[i] = ("alias", outputs[0])
        heads[outputs[0]] = lp
    return dataclasses.replace(program, nodes=tuple(nodes)), heads


def _emit_gated(program: Program, live, seeds, points, leaf, params=("SDF_P", "P"),
                accs=None, loops=(), gate_seeds: bool = False,
                at=str) -> tuple[list[str], dict, dict]:
    """The body of one large-tier adjoint, for one or two points through the
    same program. ``seeds`` are (node id, expression) pairs, the expression
    a list of one per point where they differ, ``points`` are (suffix, input
    names) pairs, and ``leaf(lines, i, node, totals, rows, at)`` writes the
    add of a parameter's or a gather's cotangent (one total per point;
    ``rows`` the gather's row names; ``at(slot)`` the C++ of a slot).
    Cotangents are ``a<id><suffix>``, and the points' are added to ``accs``
    (per point the names of x, y and z's, None for one that takes none;
    ``g{x,y,z}<suffix>`` where not given). ``params`` names the parameter
    array of the forward and of the regions' recomputes.

    The forward runs once, in full, and keeps the outcome of every select's
    comparisons as two bits of the words ``w<k><suffix>``, so that the
    reverse sweep through the selects (a union's min and where chains) reads
    no float value. The reverse sweep runs region by region (``_gating``):
    a gated node's region runs only where some lane of the warp has a
    cotangent there that is not zero (``sdf_any``), and first recomputes the
    few forward values its own pullbacks read (a primitive's), in names that
    shadow the outer ones; so few values stay live across the sweep.

    The unions of ``loops`` (``Program.loops``, :func:`_adjoint_loops`) are
    the forward's loops (reading ``P``) and keep no bits: each is one node
    of the sweep, pulled back where its outputs' cotangents are complete by
    one pass of its child's adjoint per distinct child of least distance in
    the warp (:func:`_emit_loop_vjp`).

    Returns the lines, the forward names, and counts: ``reverse``, the
    operations of the reverse sweep down the costliest path of regions,
    ``recompute``, the forward operations the regions on that path redo, and
    ``slots_added``, the parameter adds on it."""
    heads = {}
    if loops:
        program, heads = _contracted(program, loops, live)
        live = _live(program.nodes, [i for i, _ in seeds])
    nodes = program.nodes
    g = _gating(program, live, [i for i, _ in seeds], gate_seeds)
    root, level, gated = g["root"], g["level"], g["gated"]
    reached, consumers = g["reached"], g["consumers"]
    members = {}
    for j in reached:
        members.setdefault(level[j], []).append(j)
    suffixes = [sfx for sfx, _ in points]
    if accs is None:
        accs = [tuple(f"g{c}{sfx}" for c in "xyz") for sfx in suffixes]
    # A loop's pullback runs in a scope of its own: its outputs' cotangents
    # are declared, zero, in the region where it runs, and its point's where
    # the point's own pullback runs.
    fixed, looped = {}, {i for i in reached if nodes[i][0] in ("loop", "alias")}
    for h, lp in heads.items():
        fixed.update((i, level[h]) for i in (lp.dist, *lp.color) if i in reached)
        fixed.update((j, level[j]) for j in lp.point
                     if j in reached and nodes[j][0] != "input")
    # A sum that takes a cotangent inside a nested region is declared, zero,
    # in the region where it is complete.
    preset = {}
    for i in reached:
        if i in fixed:
            preset.setdefault(fixed[i], []).append(i)
        elif nodes[i][0] not in ("input", "const") and any(
                (c if c in gated else level[c]) != level[i]
                for c in consumers[i] if c in reached):
            preset.setdefault(level[i], []).append(i)
    kept = {j: k for k, j in enumerate(sorted(j for j in reached if nodes[j][0] in _SELECTS))}
    words = (len(kept) + 15) // 16
    outer_names = []

    def bit(j, which, sfx):
        k = kept[j]
        return f"((w{k // 16}{sfx} >> {2 * (k % 16) + which}) & 1u)"

    def record(sfx):
        def lines_after(i, names):
            if i not in kept:
                return []
            node, k = nodes[i], kept[i]
            word, one, two = f"w{k // 16}{sfx}", 1 << 2 * (k % 16), 2 << 2 * (k % 16)
            if node[0] == "where":
                return [f"{word} |= {names[node[1]]} ? {one}u : 0u;"]
            x, y = (names[node[1]], "0.0f") if node[0] == "abs" else (names[node[1]], names[node[2]])
            return [f"{word} |= ({x} < {y} ? {one}u : 0u) | ({x} > {y} ? {two}u : 0u);"]
        return lines_after

    be = _NamedOps()
    declared = set()

    def add(i, exprs, lines):
        node = nodes[i]
        for p, (sfx, e) in enumerate(zip(suffixes, exprs)):
            if node[0] == "input":
                if accs[p][node[1]] is not None:
                    lines.append(f"{accs[p][node[1]]} += {_s(e)};")
            elif i in declared:
                lines.append(f"a{i}{sfx} += {_s(e)};")
            else:
                lines.append(f"float a{i}{sfx} = {_s(e)};")
        if node[0] != "input":
            be.n += i in declared
            declared.add(i)

    def pull(j, names, sfx, total, want):
        """The pullback of node j for one point."""
        node = nodes[j]
        op = node[0]
        out = names.get(j, "?")
        if op in ("min", "max"):
            be.bits = {("lt", "@a", "@b"): bit(j, 0, sfx), ("gt", "@a", "@b"): bit(j, 1, sfx),
                       ("lt", "@b", "@a"): bit(j, 1, sfx), ("gt", "@b", "@a"): bit(j, 0, sfx)}
            return _pullback(op, total, out, ["@a", "@b"], be, want)
        if op == "abs":
            be.bits = {("gt", "@a", 0.0): bit(j, 0, sfx), ("lt", "@a", 0.0): bit(j, 1, sfx)}
            return _pullback(op, total, out, ["@a"], be, want)
        if op == "where":
            return _pullback(op, total, out, [bit(j, 0, sfx), "@b", "@c"], be, want)
        args = [names.get(d, "?") for d in node[1:]]
        if op == "mul" and node[1] == node[2]:
            return (be.mul(2.0, be.mul(total, args[0])), None)
        return _pullback(op, total, out, args, be, want)

    def loop_pullback(h, names):
        """The lines and path counts of the pullback of the loop at ``h``."""
        lp = heads[h]
        seeds_of = [[f"a{i}{sfx}" if i in reached else None for i in (lp.dist, *lp.color)]
                    for sfx in suffixes]
        point_accs = [tuple(None if j not in reached else accs[p][nodes[j][1]]
                            if nodes[j][0] == "input" else f"a{j}{sfx}" for j in lp.point)
                      for p, sfx in enumerate(suffixes)]
        return _emit_loop_vjp(lp, [(sfx, tuple(nm[j] for j in lp.point))
                                   for sfx, nm in zip(suffixes, names)],
                              seeds_of, point_accs, leaf,
                              any(c in reached for c in lp.color))

    def region(h):
        """(lines, forward names of the first point, path counts) of the
        region of gated node ``h`` (``root``: the whole function)."""
        lines = []
        outer = h == root
        order = sorted((j for j in members.get(h, []) if nodes[j][0] != "const"), reverse=True)
        if not outer:
            order.insert(0, h)
        if outer:
            fwd = sorted(live)
            if words:
                lines += [f"unsigned {', '.join(f'w{k}{sfx} = 0u' for k in range(words))};"
                          for sfx in suffixes]
        else:
            need, stack = set(), []
            for j in order:
                if j == h or j not in gated:
                    stack.extend(_values_needed(program, j))
            while stack:
                j = stack.pop()
                if j not in need:
                    need.add(j)
                    if nodes[j][0] not in ("loop", "alias"):  # the forward's loop gave it
                        stack.extend(_deps(nodes[j]))
            fwd = sorted(j for j in need if nodes[j][0] not in ("loop", "alias"))
        recompute = sum(nodes[j][0] not in ("const", "input", "param") for j in fwd)
        names = []
        for p, (sfx, inputs) in enumerate(points):
            # A region reads the parameters through P, which the compiler
            # cannot prove equal to the outer forward's SDF_P: so it cannot
            # merge the recomputed values with the outer ones and keep those
            # live across the sweep instead.
            body, nm = _emit_body(program, fwd, keep_rows=True, suffix=sfx, inputs=inputs,
                                  params=params[0] if outer else params[1],
                                  record=record(sfx) if outer else None,
                                  loops=loops if outer else (), loop_params="P", track=True)
            lines += body
            if outer:
                outer_names.append(nm)
            else:
                nm = {**{i: outer_names[p][i] for i in looped & need}, **nm}
            names.append(nm)
        be.lines = lines
        for i in preset.get(h, []):
            for sfx in suffixes:
                lines.append(f"float a{i}{sfx} = 0.0f;")
            declared.add(i)
        if outer:
            for i, e in seeds:
                add(i, e if isinstance(e, list) else [e] * len(points), lines)
        n0, leaves0, below, below_leaves, paths = be.n, be.leaves, 0, 0, [(0, 0, 0)]
        for j in order:
            if j not in declared:
                continue  # no cotangent reaches it
            node = nodes[j]
            if node[0] == "alias":
                continue  # its loop's pullback reads its cotangent
            if node[0] == "loop":
                inner, path = loop_pullback(j, names)
                lines += inner
                paths.append(path)
                continue
            if j != h and j in gated:
                n1, l1 = be.n, be.leaves
                inner, _, path = region(j)
                below += be.n - n1
                below_leaves += be.leaves - l1
                paths.append(path)
                be.lines = lines
                test = " || ".join(f"a{j}{sfx} != 0.0f" for sfx in suffixes)
                lines.append(f"if (sdf_any({test})) {{")
                lines += [f"  {ln}" for ln in inner]
                lines.append("}")
                continue
            totals = [f"a{j}{sfx}" for sfx in suffixes]
            if node[0] in ("param", "gather"):
                be.n += 1
                be.leaves += 1
                leaf(lines, j, node, totals, [f"k{j}{sfx}" for sfx in suffixes], at)
                continue
            deps = node[1:]
            want = [nodes[d][0] not in _NO_COTANGENT for d in deps]
            pulled = [pull(j, nm, sfx, total, want)
                      for nm, sfx, total in zip(names, suffixes, totals)]
            for k, d in enumerate(deps):
                if want[k] and pulled[0][k] is not None:
                    add(d, [q[k] for q in pulled], lines)
        reverse, redo, added = max(paths)
        return lines, names[0], (be.n - n0 - below + reverse,
                                 (0 if outer else recompute) + redo,
                                 be.leaves - leaves0 - below_leaves + added)

    lines, names, (reverse, recompute, added) = region(root)
    return lines, names, {"reverse": reverse, "recompute": recompute, "slots_added": added}


def _emit_loop_vjp(lp: UnionLoop, points, seeds, accs, leaf, want_color: bool):
    """The pullback of the union ``lp`` in a large-tier adjoint whose forward
    wrote it as its loop (:func:`_emit_loop` with ``track``). ``points`` are
    (suffix, the names of the union's point) pairs; per point, ``seeds`` are
    the names of the cotangents of the union's distance and colour (None for
    one that takes none) and ``accs`` the names that take the point's
    cotangent; ``leaf`` writes a parameter's add. Returns the lines and the
    counts of one pass.

    A union passes its distance's cotangent to the child of least distance
    alone, and its colour's to the same child, unless two children's
    distances compare equal or one's is NaN. A warp in which no lane that
    takes a cotangent here has such a point loops over the distinct children
    of least distance of its lanes and points: each pass broadcasts the first
    pending lane's child ``k`` (``sdf_first``) and runs the child's own
    adjoint (its program traced with its slots from 0, its own unions
    straight-line) at every lane's point, from ``P + base + stride * k``,
    seeded with the lane's cotangents where ``k`` is its child and zero
    elsewhere, adding to slots ``base + stride * k + j`` at a slot the warp
    shares. So a slot of a warp's row takes the sum of the same lanes'
    values in the same order as from the straight-line sweep, whose other
    children add exactly zero (``sdf_acc`` skips them), and the two forms
    agree bit for bit wherever the children's values at the lanes' points
    are finite.

    A warp in which some such lane has a tie or a NaN distance follows the
    tree's rule, which ``_pullback`` gives ``min`` and ``where``: at each
    ``Union`` of the tree (``UnionLoop.splits``) the distance's cotangent
    goes to the side whose least distance is less, and is halved between
    the two where neither is less (equal, or a side whose every child is
    NaN); the colour's goes left only where the left side's least is less.
    Each lane marks its children whose distance equals the union's least and
    those whose distance is NaN (two bit sets, from one more pass over the
    children), from which each side's least compares as the tree compares
    it; the warp then takes the children last first, as the straight-line
    sweep reaches them, and a child that some lane's walk down the tree
    (``sdf_tree_share``, ``sdf_tree_colour``) gives a cotangent takes a
    pass. The walk repeats the tree's operations
    (``0.5 * g`` to the left, ``g - ga`` to the right), so the cotangents
    are the straight-line form's bit for bit where they are finite. A
    cotangent that is not finite reaches the children of least distance
    alone, where the tree's ``g - ga`` would give the others' NaN too."""
    tag = f"L{lp.dist}"
    count, words = lp.count, (lp.count + 31) // 32
    child = dataclasses.replace(lp.child, loops=()) if lp.child.loops else lp.child
    outs = ("d", "r", "g", "b")[:4 if want_color else 1]
    sfxs = [sfx for sfx, _ in points]
    state = [f"{lp.dist}{sfx}" for sfx in sfxs]  # the names _emit_loop gave the forward's loop
    k = f"{tag}_k"
    lines = [f"// The union of {count} like children (loop {lp.dist}) pulled back: one pass of "
             "a child's adjoint per distinct child of least distance in the warp; the tree's "
             "rule where some lane's point has a tie or a NaN distance.",
             f"static const int {tag}_split[] = {{{', '.join(map(str, lp.splits))}}};"]
    for sfx, s in zip(sfxs, seeds):
        lines += [f"const float {tag}_{o}{sfx} = {e or '0.0f'};" for o, e in zip(outs, s)]
        lines.append(f"bool {tag}_m{sfx} = "
                     + " || ".join(f"{tag}_{o}{sfx} != 0.0f" for o in outs) + ";")
    lines.append(f"const bool {tag}_x = sdf_any("
                 + " || ".join(f"({tag}_m{sfx} && (tie{t} || nan{t}))"
                               for sfx, t in zip(sfxs, state)) + ");")
    lines += [f"unsigned {tag}_T{sfx}[{words}], {tag}_N{sfx}[{words}];" for sfx in sfxs]
    if want_color:
        lines += [f"int {tag}_c{sfx} = 0;" for sfx in sfxs]
    lines.append(f"if ({tag}_x) {{")
    for (sfx, point), t in zip(points, state):
        least, nan, n = f"{tag}_T{sfx}", f"{tag}_N{sfx}", f"{tag}_n{sfx}"
        body, cn = _emit_program(lp.child, [lp.child.dist], f"_m{tag}{sfx}", point,
                                 f"{tag}_Q{sfx}")
        d = _s(cn[lp.child.dist])
        lines += [f"  for (int {n} = 0; {n} < {words}; ++{n}) {least}[{n}] = {nan}[{n}] = 0u;",
                  "  #pragma unroll 1",
                  f"  for (int {n} = 0; {n} < {count}; ++{n}) {{",
                  f"    const float* __restrict__ {tag}_Q{sfx} = P + ({lp.base} + {lp.stride} * {n});",
                  *(f"    {ln}" for ln in body),
                  f"    {least}[{n} >> 5] |= ({d} == v{t} ? 1u : 0u) << ({n} & 31);",
                  f"    {nan}[{n} >> 5] |= ({d} == {d} ? 0u : 1u) << ({n} & 31);",
                  "  }"]
        if want_color:
            lines.append(f"  {tag}_c{sfx} = sdf_tree_colour({tag}_split, {count}, {least}, {nan});")
    # The tie path takes the children last first, as the straight-line sweep
    # reaches them, so that a point's cotangent sums their shares in its order.
    lines += ["}", f"int {k} = {count};", "#pragma unroll 1", "while (true) {"]
    lines += [f"  float {', '.join(f'{tag}_e{o}{sfx}' for o in outs)};" for sfx in sfxs]
    lines += [f"  if ({tag}_x) {{", f"    if (--{k} < 0) break;"]
    for sfx in sfxs:
        least, nan = f"{tag}_T{sfx}", f"{tag}_N{sfx}"
        lines.append(f"    {tag}_ed{sfx} = {tag}_m{sfx} && (sdf_bit({least}, {k}) || "
                     f"sdf_bit({nan}, {k})) ? sdf_tree_share({tag}_split, {count}, {k}, "
                     f"{tag}_d{sfx}, {least}, {nan}) : 0.0f;")
        if want_color:
            lines += [f"    {tag}_e{o}{sfx} = {tag}_m{sfx} && {tag}_c{sfx} == {k} ? "
                      f"{tag}_{o}{sfx} : 0.0f;" for o in outs[1:]]
    lines += ["    if (!sdf_any(" + " || ".join(f"{tag}_e{o}{sfx} != 0.0f" for sfx in sfxs
                                                 for o in outs) + ")) continue;",
              "  } else {"]
    pending = " || ".join(f"{tag}_m{sfx}" for sfx in sfxs)
    pick = f"i{state[-1]}"
    for sfx, t in zip(sfxs[-2::-1], state[-2::-1]):
        pick = f"{tag}_m{sfx} ? i{t} : {pick}"
    lines += [f"    if (!sdf_any({pending})) break;",
              f"    {k} = sdf_first({pending}, {pick});"]
    for sfx, t in zip(sfxs, state):
        on = f"{tag}_on{sfx}"
        lines.append(f"    const bool {on} = {tag}_m{sfx} && i{t} == {k};")
        lines += [f"    {tag}_e{o}{sfx} = {on} ? {tag}_{o}{sfx} : 0.0f;" for o in outs]
        lines.append(f"    {tag}_m{sfx} = {tag}_m{sfx} && !{on};")
    offset = f"{tag}_o"
    lines += ["  }", f"  const int {offset} = {lp.base} + {lp.stride} * {k};",
              f"  const float* __restrict__ {tag}_K = P + {offset};"]
    # The straight-line sweep reaches the union's outputs in descending id.
    child_seeds = sorted(zip((lp.dist, *lp.color), (child.dist, *child.color), outs),
                         key=lambda x: -x[0])
    body, _, counts = _emit_gated(
        child, child.eval_live if want_color else child.dist_live,
        [(c, [f"{tag}_e{o}{sfx}" for sfx in sfxs]) for _, c, o in child_seeds],
        [(f"_p{tag}{sfx}", point) for sfx, point in points], leaf,
        params=(f"{tag}_K", f"{tag}_K"), accs=accs, gate_seeds=True,
        at=lambda slot: f"{offset} + {slot}")
    lines += [f"  {ln}" for ln in body]
    lines.append("}")
    forward = sum(child.nodes[i][0] not in ("const", "input", "param")
                  for i in (child.eval_live if want_color else child.dist_live))
    return (["{", *(f"  {ln}" for ln in lines), "}"],
            (counts["reverse"], counts["recompute"] + forward, counts["slots_added"]))


@functools.lru_cache(maxsize=4)
def _large_parts(program: Program) -> dict:
    """The large tier's three adjoints: name -> (lines, forward names, counts)."""
    point = [("", ("px", "py", "pz"))]
    pair = [("a", ("pxa", "pya", "pza")), ("b", ("pxb", "pyb", "pzb"))]
    loops = _adjoint_loops(program)

    def row(node, k, at):
        _, base, _, channel, _ = node
        return f"{k} >= 0 ? {at(base)} + 3 * {k} + {channel} : -1"

    def scaled(lines, i, node, totals, rows, at):
        """The distance's: g times the unit cotangent."""
        if node[0] == "param":
            lines.append(f"sdf_acc(gP, {at(node[1])}, g * {totals[0]});")
        else:
            lines.append(f"sdf_acc_at(gP, {row(node, rows[0], at)}, g * {totals[0]});")

    def paired(lines, i, node, totals, rows, at):
        """A pair of taps': g times the difference of their unit cotangents,
        taken before the scaling where both read the same slot."""
        ta, tb = totals
        if node[0] == "param":
            lines.append(f"sdf_acc(gP, {at(node[1])}, g * ({ta} - {tb}));")
            return
        ka, kb = rows
        lines.append(f"sdf_acc_at(gP, {row(node, ka, at)}, {ka} == {kb} ? g * ({ta} - {tb}) "
                     f": g * {ta});")
        lines.append(f"sdf_acc_at(gP, {kb} != {ka} ? ({row(node, kb, at)}) : -1, -(g * {tb}));")

    def seeded(lines, i, node, totals, rows, at):
        """The colour-and-distance adjoint's: the cotangent as it is."""
        if node[0] == "param":
            lines.append(f"sdf_acc(gP, {at(node[1])}, {totals[0]});")
        else:
            lines.append(f"sdf_acc_at(gP, {row(node, rows[0], at)}, {totals[0]});")

    seeds = [*zip(program.color, ("gr", "gg", "gb")), (program.dist, "gd")]
    return {
        "dist": _emit_gated(program, program.dist_live, [(program.dist, "u")], point, scaled,
                            loops=loops),
        "pair": _emit_gated(program, program.dist_live, [(program.dist, "u")], pair, paired,
                            loops=loops),
        "eval": _emit_gated(program, program.eval_live, seeds, point, seeded, loops=loops),
    }


def emit_large_vjp_cpp(program: Program) -> str:
    """The adjoints of the large-scene tier as C++ for host and device. They
    add every parameter cotangent straight into ``gP``, a row of sums that
    ``sdf_acc`` / ``sdf_acc_at`` (``csrc/raymarch_sums.cuh``) fill: on the
    card the warp's row, its lanes' values summed in a fixed order and
    exact zeros skipped. No array of the scene's size is declared.

    * ``sdf_dist_vjp(p, P, u, g, &gp, gP)``: the distance at p; ``*gp`` is
      ``u`` times its gradient in the point and ``g * u`` times its gradient
      in the parameters is added to ``gP``. ``u`` is the unit seed (1, or 0
      for a lane that adds nothing), so the point's gradient does not wait
      for ``g``, as in the small tier's unit form.
    * ``sdf_dist_vjp_pair(pa, pb, P, u, g, &ga, &gb, gP)``: the same for two
      points (a pair of normal taps), adding ``g`` times the difference of
      their unit gradients, taken before the scaling.
    * ``sdf_eval_vjp``: as in the small tier (cotangents of colour and
      distance in, the point's cotangent out), adding to ``gP``.

    Each runs its reverse sweep region by region (:func:`_emit_gated`) and is
    a function of its own (``SDF_SPARSE``: not inlined on the card), so that
    its source is compiled once however many call sites it has. A union of
    like children that the forward writes as a loop (``Program.loops``) is
    a loop in the adjoints' forward too, which keeps each point's child of
    least distance and whether it has a tie or a NaN distance, and one node
    of their sweep: pulled back by one pass of its child's adjoint per
    distinct child of least distance in the warp, or where some lane has a
    tie by the tree's own rule (:func:`_emit_loop_vjp`), bit for bit the
    straight-line form's. A large program without such a loop keeps the
    straight-line form, source and all."""
    parts = _large_parts(program)
    head = "SDF_SPARSE"
    dist_lines, dist_names, _ = parts["dist"]
    pair_lines, _, _ = parts["pair"]
    eval_lines, eval_names, _ = parts["eval"]
    slots = {program.nodes[i][1] for i in program.dist_live if program.nodes[i][0] == "param"}
    slots |= {program.nodes[i][1] + 3 * t + program.nodes[i][3] for i in program.dist_live
              if program.nodes[i][0] == "gather" for t in range(program.nodes[i][2])}
    out = [
        "// Scene adjoint emitted by sdfkit_tpu_torch.sdf.compile: the large-scene tier.",
        "#define SDF_LARGE 1",
        f"#define SDF_N_PARAMS {program.n_params}",
        f"#define SDF_N_DIST_SLOTS {len(slots)}",
        '#include "raymarch_sums.cuh"',
        f"{head} float sdf_dist_vjp(float px, float py, float pz, const float* __restrict__ P,",
        "                          float u, float g, float* gpx, float* gpy, float* gpz,",
        "                          float* gP) {",
        "  float gx = 0.0f, gy = 0.0f, gz = 0.0f;",
        *(f"  {ln}" for ln in dist_lines),
        "  *gpx = gx;", "  *gpy = gy;", "  *gpz = gz;",
        f"  return {dist_names[program.dist]};",
        "}",
        "",
        f"{head} void sdf_dist_vjp_pair(float pxa, float pya, float pza, float pxb, float pyb,",
        "                               float pzb, const float* __restrict__ P, float u, float g,",
        "                               float* gpxa, float* gpya, float* gpza, float* gpxb,",
        "                               float* gpyb, float* gpzb, float* gP) {",
        "  float gxa = 0.0f, gya = 0.0f, gza = 0.0f, gxb = 0.0f, gyb = 0.0f, gzb = 0.0f;",
        *(f"  {ln}" for ln in pair_lines),
        "  *gpxa = gxa;", "  *gpya = gya;", "  *gpza = gza;",
        "  *gpxb = gxb;", "  *gpyb = gyb;", "  *gpzb = gzb;",
        "}",
        "",
        f"{head} float sdf_eval_vjp(float px, float py, float pz, const float* __restrict__ P,",
        "                          float gr, float gg, float gb, float gd,",
        "                          float* gpx, float* gpy, float* gpz, float* gP) {",
        "  float gx = 0.0f, gy = 0.0f, gz = 0.0f;",
        *(f"  {ln}" for ln in eval_lines),
        "  *gpx = gx;", "  *gpy = gy;", "  *gpz = gz;",
        f"  return {eval_names[program.dist]};",
        "}",
        "",
    ]
    return "\n".join(out)


__all__ = ["Program", "UnionLoop", "compile_scene", "emit_cpp", "emit_large_vjp_cpp",
           "emit_vjp_cpp", "flat_params", "large_tier", "operation_counts", "run", "run_unit",
           "run_vjp", "trace"]
