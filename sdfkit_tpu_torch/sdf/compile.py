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

The program is cached by the tree's structure (node types, callbacks, flags
and parameter shapes), and its hash is that of the emitted source, which
holds parameter slots and never parameter values: editing a value changes
nothing here and rebuilds nothing. A callback that closes over a Python
value is structure, as it was for the JAX package's ``jit``.
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
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves
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
    return dataclasses.replace(
        prog, source=source, hash=hashlib.sha256(source.encode()).hexdigest()[:16]
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
        return torch.zeros(0, dtype=torch.float32)
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


def run(program: Program, p: V3, params: torch.Tensor, want_color: bool = True):
    """Execute the program on tensors: returns (color V3, dist), or
    (None, dist) with ``want_color=False``. Constant outputs come back as
    Python floats."""
    vals = {}
    for i in program.eval_live if want_color else program.dist_live:
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
    dist = vals[program.dist]
    if not want_color:
        return None, dist
    return V3(*(vals[c] for c in program.color)), dist


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


def _emit_body(program: Program, live) -> tuple[list[str], dict]:
    names = {}
    lines = []
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


__all__ = ["Program", "compile_scene", "emit_cpp", "flat_params", "run", "trace"]
