"""SDF expression DSL over torch: every node an ``nn.Module``.

Counterpart of ``sdfkit_tpu/sdf/expr.py``. A node's array fields are
``nn.Parameter``s (``Repeat.sizes`` is an ``nn.ParameterList`` of scalars),
its callbacks and flags are plain attributes, and its ``eval`` is written only
against :mod:`sdfkit_tpu_torch.ops` and :class:`V3`. The same ``eval`` then
runs on tensors (the plain renderer, with autograd) and on the scene
compiler's symbolic values (the CUDA kernel's scene body, ``sdf/compile.py``).
User callbacks (``solid``, ``modify_*``, ``color_fn``, ``index_fn``) must be
written against ``ops`` too.

Evaluation protocol (structure-of-arrays):

    expr.eval(p: V3) -> (color: V3, dist)       # any component shape
    expr(points)     -> (..., 4) tensor         # rgb in [...,:3], dist in [...,3]

``eval(p)`` replaces ``nn.Module.eval()``: SDF nodes have no training mode.

``leaves(expr)`` lists the parameters in the order ``jax.tree_util.tree_leaves``
gives for the same tree in the JAX package (each class's ``fields`` is its
``@sdf_node`` data-field order), so weights cross between the packages with
``load_leaves``.

An edit of any scene's structure counts in ``EDITS``: a field, child,
parameter or static set on a node (``setattr``, ``add_module``,
``register_parameter``, ``del``), an edit of a scalar list, and a move
(``.to(...)`` and every other ``nn.Module._apply``). The scene compiler keeps
each tree's program and leaves until the count moves (``compile_scene``). An
edit of values alone (``load_leaves``, an optimizer's step in place) does not
count: the flat parameters read the current tensors.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.device import default_device, resolve
from sdfkit_tpu_torch.utils.v3 import V3, vmod


EDITS = 0  # edits of any scene's structure in this process (module docstring)


def _edited() -> None:
    global EDITS
    EDITS += 1


class _CountsEdits:
    """Counts in ``EDITS`` every way ``nn.Module`` lets a caller change what
    a module holds, after the change: a walk that reads the count before it
    starts then never keeps a structure older than the count says. A plain
    ``nn.ParameterList`` set on a node becomes a ``ScalarList``."""

    def __setattr__(self, name, value):
        super().__setattr__(name, _scalar_list(value))
        _edited()

    def __delattr__(self, name):
        super().__delattr__(name)
        _edited()

    def add_module(self, name, module):
        super().add_module(name, _scalar_list(module))
        _edited()

    def register_parameter(self, name, param):
        super().register_parameter(name, param)
        _edited()

    def _apply(self, fn, recurse=True):
        out = super()._apply(fn, recurse)  # may put new Parameter objects in place
        _edited()
        return out


class ScalarList(_CountsEdits, nn.ParameterList):
    """A node's scalar list (``scalar_lists``): an ``nn.ParameterList`` whose
    edits count as edits of the scene's structure."""


def _scalar_list(value):
    """``value``, a plain ``nn.ParameterList`` made a ``ScalarList`` in place
    (the caller's handle stays the node's list)."""
    if type(value) is nn.ParameterList:
        value.__class__ = ScalarList
    return value


def _param(v, device: torch.device) -> nn.Parameter:
    """A value as a float32 parameter of its own on ``device``."""
    return nn.Parameter(torch.as_tensor(v, dtype=torch.float32).detach().to(device, copy=True))


def _color3(c) -> torch.Tensor:
    """A color spec (scalar, 3-seq, or tensor) as a (3,) float32 tensor.
    Only the shape is settled here; the node's constructor places it."""
    c = torch.as_tensor(c, dtype=torch.float32)
    if c.ndim == 0:
        c = c.expand(3)
    return c


def _vec3(x, y, z) -> torch.Tensor:
    if y is None:
        return _color3(x)
    return torch.tensor([float(x), float(y), float(z)], dtype=torch.float32)


class SdfExpr(_CountsEdits, nn.Module):
    """Base class: a differentiable signed distance field.

    Subclasses list their parameter-or-child fields in ``fields`` (JAX
    pytree order) and their static fields (callbacks, flags) in ``statics``;
    the constructor takes them positionally in that order, or by name.

    Parameters are made on ``device``; without one, a node follows its
    child's parameters (so ``scene.translate(...)`` stays where the scene
    is), and a node with no child goes to the package's default device
    (``sdfkit_tpu_torch.device``: the card, unless the CPU was asked for)."""

    fields: tuple[str, ...] = ()
    statics: tuple[str, ...] = ()
    scalar_lists: tuple[str, ...] = ()  # fields held as a tuple of scalars

    def __init__(self, *args, device=None, **kwargs):
        super().__init__()
        names = self.fields + self.statics
        if len(args) > len(names):
            raise TypeError(f"{type(self).__name__} takes {len(names)} fields")
        bound = dict(zip(names, args))
        bound.update(kwargs)
        missing = [n for n in names if n not in bound]
        if missing or len(bound) != len(names):
            raise TypeError(f"{type(self).__name__} needs fields {names}, got {sorted(bound)}")
        if device is None:
            inherited = [p.device for v in bound.values() if isinstance(v, SdfExpr)
                         for p in leaves(v)[:1]]
            device = inherited[0] if inherited else None
        for name in self.fields:
            v = bound[name]
            if isinstance(v, SdfExpr):
                self.add_module(name, v)
                continue
            device = resolve(device)  # raises when there is no card and no request
            if name in self.scalar_lists:
                self.add_module(name, ScalarList([_param(s, device) for s in v]))
            else:
                self.register_parameter(name, _param(v, device))
        for name in self.statics:
            setattr(self, name, bound[name])

    # -- protocol ---------------------------------------------------------
    def eval(self, p: V3):  # noqa: A003 -- the field's evaluation, see module doc
        raise NotImplementedError

    def distance(self, p: V3):
        return self.eval(p)[1]

    def forward(self, points: torch.Tensor) -> torch.Tensor:
        """Batched evaluation: (..., 3) points -> (..., 4) rgb+distance."""
        p = V3.from_array(torch.as_tensor(points, dtype=torch.float32))
        color, dist = self.eval(p)
        return torch.stack(
            [ops.broadcast_to(c, dist.shape) for c in (color.x, color.y, color.z)]
            + [dist],
            dim=-1,
        )

    # -- CSG combinators --------------------------------------------------
    def union(self, other: "SdfExpr") -> "SdfExpr":
        return Union(self, other)

    def __or__(self, other):
        return self.union(other)

    def intersect(self, other: "SdfExpr") -> "SdfExpr":
        return Intersection(self, other)

    def __and__(self, other):
        return self.intersect(other)

    def subtract(self, other: "SdfExpr") -> "SdfExpr":
        return Subtraction(self, other)

    def smooth_union(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothUnion(self, other, k)

    def smooth_intersect(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothIntersection(self, other, k)

    def smooth_subtract(self, other: "SdfExpr", k) -> "SdfExpr":
        return SmoothSubtraction(self, other, k)

    # -- domain modifiers -------------------------------------------------
    def translate(self, x, y=None, z=None) -> "SdfExpr":
        return Translate(self, _vec3(x, y, z))

    def scale(self, s) -> "SdfExpr":
        return Scale(self, s)

    def rotate_x(self, angle) -> "SdfExpr":
        return Rotate(self, angle, axis="x")

    def rotate_y(self, angle) -> "SdfExpr":
        return Rotate(self, angle, axis="y")

    def rotate_z(self, angle) -> "SdfExpr":
        return Rotate(self, angle, axis="z")

    def round(self, radius) -> "SdfExpr":
        """Rounded offset surface: d - r."""
        return Round(self, radius)

    def shell(self, thickness) -> "SdfExpr":
        """Hollow shell of the surface: |d| - t/2."""
        return Shell(self, thickness)

    def modify_input(self, fn: Callable[[V3], V3]) -> "SdfExpr":
        """Position warp ``fn(p) -> p'``."""
        return ModifyInput(self, fn)

    def modify_output(self, fn: Callable) -> "SdfExpr":
        """Color rewrite ``fn(p, color, dist) -> color``."""
        return ModifyOutput(self, fn)

    def modify_input_and_output(self, fn_in, fn_out) -> "SdfExpr":
        """``fn_in(p) -> (warped, index)``;
        ``fn_out(index, warped, color, dist) -> color``."""
        return ModifyInputAndOutput(self, fn_in, fn_out)

    def color(self, r, g=None, b=None) -> "SdfExpr":
        """Override the output color."""
        return WithColor(self, _vec3(r, g, b))

    with_color = color

    # Domain repetition: p' = mod(p + s/2, s) - s/2, cell i = floor((p + s/2)/s).
    def repeat_x(self, size_x) -> "SdfExpr":
        return Repeat(self, (size_x,), axes="x", color_fn=None)

    def repeat_y(self, size_y) -> "SdfExpr":
        return Repeat(self, (size_y,), axes="y", color_fn=None)

    def repeat_xy(self, size_x, size_y, color_fn=None) -> "SdfExpr":
        """``color_fn(index: V3, p: V3, color: V3, dist) -> V3`` per cell."""
        return Repeat(self, (size_x, size_y), axes="xy", color_fn=color_fn)

    def repeat_xz(self, size_x, size_z, color_fn=None) -> "SdfExpr":
        return Repeat(self, (size_x, size_z), axes="xz", color_fn=color_fn)

    def repeat_xyz(self, size_x, size_y, size_z, color_fn=None) -> "SdfExpr":
        return Repeat(self, (size_x, size_y, size_z), axes="xyz", color_fn=color_fn)

    def repeat_indexed(self, axes: str, sizes, table, index_fn=None,
                       combine: str = "replace") -> "SdfExpr":
        """Domain repetition whose cell color is a row of the (T, 3)
        parameter ``table``, picked by ``index_fn(ix, iy, iz)`` mod T."""
        if combine not in ("replace", "multiply"):
            raise ValueError(f"unknown combine mode {combine!r}")
        if any(a not in "xyz" for a in axes) or not axes:
            raise ValueError(f"axes must be a subset of 'xyz', got {axes!r}")
        sizes = tuple(sizes)
        if len(sizes) != len(axes):
            raise ValueError(
                f"got {len(sizes)} sizes for {len(axes)} axes ({axes!r})"
            )
        return RepeatIndexedColor(
            self, sizes, table, axes=axes, index_fn=index_fn, combine=combine
        )

    # -- conversions ------------------------------------------------------
    def sample(self, points, batch_size: int | None = None) -> torch.Tensor:
        """Evaluate at (N, 3) points, at most ``batch_size`` at a time."""
        from sdfkit_tpu_torch.sdf.sample import DEFAULT_BATCH_SIZE, sample

        return sample(self, points, DEFAULT_BATCH_SIZE if batch_size is None else batch_size)

    def to_sdf(self) -> Callable[[torch.Tensor], torch.Tensor]:
        """The batched callable ``(..., 3) points -> (..., 4)`` (the JAX
        package returns ``jax.jit`` of it; torch runs eagerly)."""
        return self.__call__

    def to_voxels(self, vmin, vmax, nx, ny, nz, clip_to_bounds=True):
        from sdfkit_tpu_torch.grid import voxelize

        return voxelize(self, vmin, vmax, nx, ny, nz, clip_to_bounds=clip_to_bounds)

    def to_mesh(self, vmin, vmax, nx, ny, nz, clip_to_bounds=True, iso_value=0.0, step=1,
                progress=None):
        """Voxelize on the scene's device, then mesh (no autograd tape)."""
        with torch.no_grad():
            v = self.to_voxels(vmin, vmax, nx, ny, nz, clip_to_bounds=clip_to_bounds)
        return v.to_mesh(iso_value=iso_value, step=step, progress=progress)

    def to_image(self, width, height, camera=None, **kwargs) -> torch.Tensor:
        from sdfkit_tpu_torch.render.raymarch import RayMarcher

        return RayMarcher(width, height, self, **kwargs).render(camera=camera)


# ---------------------------------------------------------------------------
# Primitives.
# ---------------------------------------------------------------------------


class Sphere(SdfExpr):
    """Exact sphere: |p| - r."""

    fields = ("radius", "rgb")

    def eval(self, p: V3):
        return V3.splat(self.rgb), p.length() - self.radius


class Box(SdfExpr):
    """Exact box: |max(q,0)| + min(max(q.x,q.y,q.z), 0), q = |p| - b."""

    fields = ("bounds", "rgb")

    def eval(self, p: V3):
        wd = p.abs() - V3.splat(self.bounds)
        outside = wd.max(0.0).zero_safe_length()
        inside = wd.min(0.0).vmax()
        return V3.splat(self.rgb), outside + inside


class Cylinder(SdfExpr):
    """Y-axis cylinder: max(sqrt(x²+z²) - r, |y| - h)."""

    fields = ("radius", "height", "rgb")

    def eval(self, p: V3):
        radial = ops.sqrt(p.x * p.x + p.z * p.z) - self.radius
        axial = ops.abs(p.y) - self.height
        return V3.splat(self.rgb), ops.maximum(radial, axial)


class Plane(SdfExpr):
    """Half-space: dot(p, n) + d."""

    fields = ("normal", "offset", "rgb")

    def eval(self, p: V3):
        return V3.splat(self.rgb), p.dot(V3.splat(self.normal)) + self.offset


class Solid(SdfExpr):
    """Wrap a plain distance function ``fn(p: V3)`` written against ops."""

    fields = ("rgb",)
    statics = ("fn",)

    def eval(self, p: V3):
        return V3.splat(self.rgb), self.fn(p)


class Torus(SdfExpr):
    """Torus in the XZ plane: |(len(p.xz) - R, p.y)| - r. radii = (R, r)."""

    fields = ("rgb", "radii")

    def eval(self, p: V3):
        big, small = self.radii[0], self.radii[1]
        q = ops.sqrt(p.x * p.x + p.z * p.z) - big
        return V3.splat(self.rgb), ops.sqrt(q * q + p.y * p.y) - small


class Capsule(SdfExpr):
    """Capsule between points a and b with the given radius."""

    fields = ("a", "b", "radius", "rgb")

    def eval(self, p: V3):
        a = V3.splat(self.a)
        b = V3.splat(self.b)
        pa = p - a
        ba = b - a
        h = ops.clip(pa.dot(ba) / ba.dot(ba), 0.0, 1.0)
        return V3.splat(self.rgb), (pa - ba * h).length() - self.radius


# ---------------------------------------------------------------------------
# CSG.
# ---------------------------------------------------------------------------


class Union(SdfExpr):
    """Whichever output has the smaller distance (``da < db ? a : b``)."""

    fields = ("a", "b")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        return ca.where(da < db, cb), ops.minimum(da, db)


class Intersection(SdfExpr):
    fields = ("a", "b")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        return ca.where(da > db, cb), ops.maximum(da, db)


class Subtraction(SdfExpr):
    """a minus b: max(da, -db); color follows a."""

    fields = ("a", "b")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        _, db = self.b.eval(p)
        return ca, ops.maximum(da, -db)


def _lerp(a, b, t):
    return a + (b - a) * t


def _smooth_mix(da, db, k, sign):
    """Polynomial smooth min (iq). sign=+1 union, -1 intersection."""
    h = ops.clip(0.5 + 0.5 * sign * (db - da) / k, 0.0, 1.0)
    d = _lerp(sign * db, sign * da, h) - k * h * (1.0 - h)
    return sign * d, h


def _blend(ca: V3, cb: V3, h) -> V3:
    return V3(_lerp(cb.x, ca.x, h), _lerp(cb.y, ca.y, h), _lerp(cb.z, ca.z, h))


class SmoothUnion(SdfExpr):
    """Polynomial smooth union with color blending."""

    fields = ("a", "b", "k")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        d, h = _smooth_mix(da, db, self.k, 1.0)
        return _blend(ca, cb, h), d


class SmoothIntersection(SdfExpr):
    fields = ("a", "b", "k")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        cb, db = self.b.eval(p)
        d, h = _smooth_mix(da, db, self.k, -1.0)
        return _blend(ca, cb, h), d


class SmoothSubtraction(SdfExpr):
    fields = ("a", "b", "k")

    def eval(self, p: V3):
        ca, da = self.a.eval(p)
        _, db = self.b.eval(p)
        h = ops.clip(0.5 - 0.5 * (da + db) / self.k, 0.0, 1.0)
        return ca, _lerp(da, -db, h) + self.k * h * (1.0 - h)


# ---------------------------------------------------------------------------
# Modifiers.
# ---------------------------------------------------------------------------


class Translate(SdfExpr):
    fields = ("child", "offset")

    def eval(self, p: V3):
        return self.child.eval(p - V3.splat(self.offset))


class Scale(SdfExpr):
    """Uniform scale; distance corrected by the factor to stay a metric SDF."""

    fields = ("child", "factor")

    def eval(self, p: V3):
        c, d = self.child.eval(p / self.factor)
        return c, d * self.factor


class Rotate(SdfExpr):
    """Rotate the shape about a coordinate axis by ``angle`` radians."""

    fields = ("child", "angle")
    statics = ("axis",)

    def eval(self, p: V3):
        c = ops.cos(self.angle)
        s = ops.sin(self.angle)
        if self.axis == "x":
            q = V3(p.x, c * p.y + s * p.z, -s * p.y + c * p.z)
        elif self.axis == "y":
            q = V3(c * p.x - s * p.z, p.y, s * p.x + c * p.z)
        else:
            q = V3(c * p.x + s * p.y, -s * p.x + c * p.y, p.z)
        return self.child.eval(q)


class Round(SdfExpr):
    fields = ("child", "radius")

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return c, d - self.radius


class Shell(SdfExpr):
    fields = ("child", "thickness")

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return c, ops.abs(d) - self.thickness * 0.5


class ModifyInput(SdfExpr):
    fields = ("child",)
    statics = ("fn",)

    def eval(self, p: V3):
        return self.child.eval(self.fn(p))


class ModifyOutput(SdfExpr):
    fields = ("child",)
    statics = ("fn",)

    def eval(self, p: V3):
        c, d = self.child.eval(p)
        return self.fn(p, c, d), d


class ModifyInputAndOutput(SdfExpr):
    fields = ("child",)
    statics = ("fn_in", "fn_out")

    def eval(self, p: V3):
        warped, index = self.fn_in(p)
        c, d = self.child.eval(warped)
        return self.fn_out(index, warped, c, d), d


class WithColor(SdfExpr):
    fields = ("child", "rgb")

    def eval(self, p: V3):
        _, d = self.child.eval(p)
        return V3.splat(self.rgb), d


def _repeat_warp(p: V3, axes: str, sizes):
    """The warped point and the cell index of domain repetition."""
    comps = {"x": p.x, "y": p.y, "z": p.z}
    idx = {a: ops.zeros_like(comps[a]) for a in "xyz"}
    for axis, size in zip(axes, sizes):
        half = size * 0.5
        comps[axis] = vmod(comps[axis] + half, size) - half
        idx[axis] = ops.floor((getattr(p, axis) + half) / size)
    return V3(comps["x"], comps["y"], comps["z"]), V3(idx["x"], idx["y"], idx["z"])


class Repeat(SdfExpr):
    """Domain repetition along ``axes`` with an optional per-cell color."""

    fields = ("child", "sizes")
    statics = ("axes", "color_fn")
    scalar_lists = ("sizes",)

    def eval(self, p: V3):
        warped, index = _repeat_warp(p, self.axes, self.sizes)
        c, d = self.child.eval(warped)
        if self.color_fn is not None:
            c = self.color_fn(index, warped, c, d)
        return c, d


class RepeatIndexedColor(SdfExpr):
    """Domain repetition whose cell color is row ``index_fn(ix, iy, iz) mod
    T`` of the (T, 3) parameter ``table`` (default index ``ix + iy + iz``).
    The row is a gather here and a direct load in the kernel, where the JAX
    package unrolled a one-hot blend; both give 0 for a position that is
    not an integer in [0, T). ``combine``: 'replace' or 'multiply'."""

    fields = ("child", "sizes", "table")
    statics = ("axes", "index_fn", "combine")
    scalar_lists = ("sizes",)

    def eval(self, p: V3):
        warped, index = _repeat_warp(p, self.axes, self.sizes)
        c, d = self.child.eval(warped)
        if self.index_fn is None:
            pos = index.x + index.y + index.z
        else:
            pos = self.index_fn(index.x, index.y, index.z)
        t_count = self.table.shape[0]
        pos = pos - ops.floor(pos / t_count) * t_count
        cr, cg, cb = ops.take_rows(self.table, pos)
        if self.combine == "multiply":
            return V3(c.x * cr, c.y * cg, c.z * cb), d
        return V3(*(ops.broadcast_to(v, d.shape) for v in (cr, cg, cb))), d


# ---------------------------------------------------------------------------
# Parameters in the JAX package's leaf order.
# ---------------------------------------------------------------------------


def leaves(expr: SdfExpr) -> list[nn.Parameter]:
    """The parameters in ``jax.tree_util.tree_leaves`` order."""
    out = []
    for name in expr.fields:
        v = getattr(expr, name)
        if isinstance(v, SdfExpr):
            out.extend(leaves(v))
        elif isinstance(v, nn.ParameterList):
            out.extend(v)
        else:
            out.append(v)
    return out


def load_leaves(expr: SdfExpr, arrays: Sequence) -> None:
    """Copy arrays (in ``leaves`` order) into the parameters, in place.
    Every shape must match."""
    params = leaves(expr)
    if len(arrays) != len(params):
        raise ValueError(f"got {len(arrays)} arrays for {len(params)} leaves")
    for i, (p, a) in enumerate(zip(params, arrays)):
        a = np.asarray(a, np.float32)
        if tuple(a.shape) != tuple(p.shape):
            raise ValueError(
                f"leaf {i}: array of shape {a.shape} for a parameter of shape "
                f"{tuple(p.shape)}"
            )
    with torch.no_grad():
        for p, a in zip(params, arrays):
            p.copy_(torch.from_numpy(np.array(a, np.float32)))


def scene_device(expr: SdfExpr) -> torch.device:
    """The device of the scene's parameters (all must share one); the
    package's default device for a scene with no parameters."""
    devs = {p.device for p in leaves(expr)}
    if len(devs) > 1:
        raise ValueError(f"scene parameters are on several devices: {sorted(map(str, devs))}")
    return devs.pop() if devs else default_device()


# ---------------------------------------------------------------------------
# Convenience constructors.
# ---------------------------------------------------------------------------

_WHITE = (1.0, 1.0, 1.0)


# ``device=None`` is the package's default device: the card, unless the CPU
# was asked for (``sdfkit_tpu_torch.device``).


def sphere(radius, color=_WHITE, device=None) -> Sphere:
    return Sphere(radius, _color3(color), device=device)


def box(bounds, color=_WHITE, device=None) -> Box:
    return Box(_color3(bounds), _color3(color), device=device)


def cylinder(radius, height, color=_WHITE, device=None) -> Cylinder:
    return Cylinder(radius, height, _color3(color), device=device)


def plane(normal, offset=0.0, color=_WHITE, device=None) -> Plane:
    return Plane(_color3(normal), offset, _color3(color), device=device)


def plane_xy(z=0.0, color=_WHITE, device=None) -> Plane:
    return plane((0.0, 0.0, 1.0), z, color, device=device)


def plane_xz(y=0.0, color=_WHITE, device=None) -> Plane:
    return plane((0.0, 1.0, 0.0), y, color, device=device)


def solid(fn, color=_WHITE, device=None) -> Solid:
    return Solid(_color3(color), fn, device=device)


def torus(big_radius, small_radius, color=_WHITE, device=None) -> Torus:
    return Torus(_color3(color), (float(big_radius), float(small_radius)), device=device)


def capsule(a, b, radius, color=_WHITE, device=None) -> Capsule:
    return Capsule(_color3(a), _color3(b), radius, _color3(color), device=device)


def union(*exprs: SdfExpr) -> SdfExpr:
    out = exprs[0]
    for e in exprs[1:]:
        out = Union(out, e)
    return out
