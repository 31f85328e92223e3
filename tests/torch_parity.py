"""One scene, built in both packages: the JAX reference and the torch port.

``build(name)`` returns ``(jax_expr, torch_expr)`` with the JAX leaves carried
across into the port through ``load_leaves``. Callbacks are static structure,
so each package gets its own copy of the same callback: ``jnp`` calls on the
JAX side, ``sdfkit_tpu_torch.ops`` calls on the port's.

With ``perturb_seed`` the JAX leaves are first scaled by ``1 + 0.1*u``
(u ~ U[-1, 1] from numpy's generator), so a wrong leaf order in the port
shows up as wrong values rather than hiding behind repeated defaults.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
from sdfkit_tpu.utils.v3 import V3 as JV
from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.scenes import balanced_union, union_grid_scene, union_grid_table
from sdfkit_tpu_torch.utils.v3 import V3 as TV

PALETTE = [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]]


# -- callbacks, one copy per package ----------------------------------------

def j_cell_color(i, p, c, d):
    return JV(0.9 - jnp.abs(i.x) / 6.0, 0.9 - jnp.abs(i.y) / 6.0, jnp.full_like(i.z, 0.9))


def t_cell_color(i, p, c, d):
    return TV(0.9 - ops.abs(i.x) / 6.0, 0.9 - ops.abs(i.y) / 6.0, ops.full_like(i.z, 0.9))


def j_bench_color(i, p, c, d):
    return JV(0.9 - jnp.abs(i.x) / 6.0, 0.9 - jnp.abs(i.y) / 6.0, 0.9 - jnp.abs(i.z) / 6.0)


def t_bench_color(i, p, c, d):
    return TV(0.9 - ops.abs(i.x) / 6.0, 0.9 - ops.abs(i.y) / 6.0, 0.9 - ops.abs(i.z) / 6.0)


def j_checker(i, p, c, d):
    pos = i.x + i.y
    pos = pos - jnp.floor(pos / 2.0) * 2.0
    w = (pos == 0).astype(jnp.float32)
    return JV(w * 1.0, (1.0 - w) * 1.0, jnp.zeros_like(w))


def t_checker(i, p, c, d):
    pos = i.x + i.y
    pos = pos - ops.floor(pos / 2.0) * 2.0
    w = ops.where(pos == 0, 1.0, 0.0)
    return TV(w * 1.0, (1.0 - w) * 1.0, ops.zeros_like(w))


def j_shear(p):
    return JV(p.x - p.y, p.y, p.z)


def t_shear(p):
    return TV(p.x - p.y, p.y, p.z)


def j_out(p, c, d):
    return JV(jnp.abs(p.x), c.y * 0.5, jnp.zeros_like(d))


def t_out(p, c, d):
    return TV(ops.abs(p.x), c.y * 0.5, ops.zeros_like(d))


def j_warp_in(p):
    return JV(p.x * 0.5, jnp.sin(p.y), jnp.cos(p.z)), JV(jnp.floor(p.x), p.y, p.z)


def t_warp_in(p):
    return TV(p.x * 0.5, ops.sin(p.y), ops.cos(p.z)), TV(ops.floor(p.x), p.y, p.z)


def j_warp_out(i, p, c, d):
    return JV(jnp.clip(i.x * 0.1, 0.0, 1.0), jnp.where(d < 0.0, 1.0, c.y), jnp.minimum(c.z, 0.3))


def t_warp_out(i, p, c, d):
    return TV(ops.clip(i.x * 0.1, 0.0, 1.0), ops.where(d < 0.0, 1.0, c.y), ops.minimum(c.z, 0.3))


def j_solid(p):
    return jnp.maximum(p.length() - 1.2, jnp.abs(p.y) - 0.5)


def t_solid(p):
    return ops.maximum(p.length() - 1.2, ops.abs(p.y) - 0.5)


def j_index(ix, iy, iz):
    return ix * 3.0


def j_union_grid(n):
    """The port's ``union_grid_scene`` in the JAX package's DSL: the same
    table of spheres, the same pairing (``_union_tree``'s)."""
    t = union_grid_table(n)
    return balanced_union([
        sk.sphere(float(r), color=tuple(map(float, c))).translate(*map(float, o))
        for r, c, o in zip(t["radius"], t["color"], t["offset"])
    ])


def t_index(ix, iy, iz):
    return ix * 3.0


# -- scenes ------------------------------------------------------------------

def _scenes(m, lib):
    """name -> scene constructor, with ``m`` the package and ``lib`` the callbacks."""
    cb = lib
    return {
        "sphere": lambda: m.sphere(1.0, color=(0.9, 0.4, 0.2)),
        "box": lambda: m.box((0.8, 0.5, 0.3), color=(0.2, 0.5, 0.9)),
        "cylinder": lambda: m.cylinder(0.5, 1.0, color=(0.3, 0.6, 0.1)),
        "plane": lambda: m.plane((0.2, 0.9, 0.1), 0.3, color=(0.5, 0.5, 0.5)),
        "plane_xy": lambda: m.plane_xy(0.1),
        "plane_xz": lambda: m.plane_xz(-0.2),
        "solid": lambda: m.solid(cb["solid"], color=(1.0, 0.0, 0.0)),
        "torus": lambda: m.torus(1.0, 0.3, color=(0.7, 0.7, 0.1)),
        "capsule": lambda: m.capsule((-1.0, 0.0, 0.0), (1.0, 0.5, 0.0), 0.4),
        "union": lambda: m.sphere(0.8, color=(0.9, 0.4, 0.2)) | m.box(0.4).translate(1.0, 0.0, 0.0),
        "union_n": lambda: m.union(m.sphere(0.5), m.box(0.3).translate(1.0, 0, 0),
                                   m.torus(0.8, 0.2).translate(0, 1.0, 0)),
        "intersection": lambda: m.sphere(1.0) & m.box(0.7, color=(0.1, 0.2, 0.3)),
        "subtraction": lambda: m.box(0.8).subtract(m.sphere(1.0)),
        "smooth_union": lambda: m.sphere(0.8, color=(0.9, 0.3, 0.2)).smooth_union(
            m.box(0.6, color=(0.2, 0.5, 0.9)).translate(0.9, 0, 0), 0.3),
        "smooth_intersect": lambda: m.sphere(1.0).smooth_intersect(m.box(0.8, color=(0.1, 0.9, 0.1)), 0.2),
        "smooth_subtract": lambda: m.box(0.8).smooth_subtract(m.sphere(0.9), 0.25),
        "translate": lambda: m.sphere(0.7).translate(0.3, -0.2, 0.5),
        "scale": lambda: m.box(0.5).scale(1.7),
        "rotate_x": lambda: m.box((0.9, 0.3, 0.2)).rotate_x(0.4),
        "rotate_y": lambda: m.box((0.9, 0.3, 0.2)).rotate_y(-0.7),
        "rotate_z": lambda: m.box((0.9, 0.3, 0.2)).rotate_z(1.1),
        "round": lambda: m.box(0.5).round(0.2),
        "shell": lambda: m.sphere(1.0).shell(0.2),
        "modify_input": lambda: m.sphere(1.0).modify_input(cb["shear"]),
        "modify_output": lambda: m.sphere(1.0).modify_output(cb["out"]),
        "modify_input_and_output": lambda: m.sphere(0.9, color=(0.4, 0.5, 0.6))
        .modify_input_and_output(cb["warp_in"], cb["warp_out"]),
        "with_color": lambda: m.sphere(1.0).color(0.2, 0.3, 0.4),
        "repeat_x": lambda: m.cylinder(0.25, 0.5).repeat_x(1.0),
        "repeat_xy_plain": lambda: m.sphere(1.0, color=(0.9, 0.4, 0.2)).repeat_xy(2.5, 2.5),
        "repeat_y": lambda: m.sphere(0.3).repeat_y(1.1),
        "repeat_xy": lambda: m.sphere(0.5).repeat_xy(1.125, 1.125, cb["cell"]),
        "repeat_xy_checker": lambda: m.sphere(0.4).repeat_xy(1.0, 1.0, cb["checker"]),
        "repeat_xz": lambda: m.box(0.25).repeat_xz(1.5, 1.5, cb["bench"]),
        "repeat_xyz": lambda: m.sphere(0.3).repeat_xyz(1.0, 1.2, 1.4, cb["bench"]),
        "repeat_indexed": lambda: m.sphere(0.5).repeat_indexed("xy", (1.125, 1.125), cb["palette"]),
        "repeat_indexed_multiply": lambda: m.sphere(0.3, color=(0.8, 0.4, 0.2)).repeat_indexed(
            "x", (1.0,), cb["palette"][:2], index_fn=cb["index"], combine="multiply"),
        "sphere_repeat": lambda: (m.sphere(0.5).repeat_xy(1.125, 1.125, cb["bench"])
                                  | m.box(0.25).repeat_xz(1.5, 1.5, cb["bench"])),
        # The backward's large-scene tier: 200 spheres (1,400 slots) and 24
        # (168), past its threshold.
        "union_grid": lambda: cb["union_grid"](200),
        "union_grid_24": lambda: cb["union_grid"](24),
    }


_J = dict(cell=j_cell_color, bench=j_bench_color, checker=j_checker, shear=j_shear,
          out=j_out, warp_in=j_warp_in, warp_out=j_warp_out, solid=j_solid,
          index=j_index, palette=jnp.asarray(PALETTE, jnp.float32), union_grid=j_union_grid)
_T = dict(cell=t_cell_color, bench=t_bench_color, checker=t_checker, shear=t_shear,
          out=t_out, warp_in=t_warp_in, warp_out=t_warp_out, solid=t_solid,
          index=t_index, palette=np.asarray(PALETTE, np.float32), union_grid=union_grid_scene)

# The scenes of the large tier are held to the JAX package in
# tests/test_torch_bigscene.py, at the sizes this CPU affords (the JAX side
# runs op by op there: its jit takes minutes on a tree of this size). NAMES
# is every other scene, which the per-scene tests walk.
LARGE_NAMES = ("union_grid", "union_grid_24")
NAMES = tuple(name for name in _scenes(sk, _J) if name not in LARGE_NAMES)


def build(name: str, perturb_seed: int | None = None):
    """(jax_expr, torch_expr) of scene ``name``, with equal parameters."""
    jexpr = _scenes(sk, _J)[name]()
    texpr = _scenes(st, _T)[name]()
    jleaves, treedef = jax.tree_util.tree_flatten(jexpr)
    arrays = [np.asarray(l, np.float32) for l in jleaves]
    if perturb_seed is not None:
        rng = np.random.default_rng(perturb_seed)
        arrays = [
            (a * (1.0 + 0.1 * rng.uniform(-1.0, 1.0, a.shape))).astype(np.float32)
            for a in arrays
        ]
        jexpr = jax.tree_util.tree_unflatten(treedef, [jnp.asarray(a) for a in arrays])
    st.load_leaves(texpr, arrays)
    return jexpr, texpr


def jax_leaf_shapes(jexpr):
    return [tuple(np.shape(l)) for l in jax.tree_util.tree_leaves(jexpr)]


def leaf_grads(texpr):
    """The inverse of the weights' crossing, for gradients: the port's leaf
    ``.grad``s as numpy arrays in ``jax.tree_util.tree_leaves`` order (zeros
    for a leaf no gradient reached), to hold against ``jax.grad``'s leaves."""
    return [
        (np.zeros(tuple(p.shape), np.float32) if p.grad is None else p.grad.detach().cpu().numpy())
        for p in st.leaves(texpr)
    ]


def jax_leaf_grads(jgrads):
    """``jax.grad``'s pytree of cotangents as numpy arrays, leaf by leaf."""
    return [np.asarray(l, np.float32) for l in jax.tree_util.tree_leaves(jgrads)]


def rays(n_or_shape, seed: int):
    """Seeded rays that are no camera's: origins scattered around (0, 0, 5),
    each aimed at its own point of the z=0 plane. Returns ``(ro, rd)`` as
    float32 numpy arrays of shape (*shape, 3), ``rd`` normalised."""
    shape = (n_or_shape,) if isinstance(n_or_shape, int) else tuple(n_or_shape)
    rng = np.random.default_rng(seed)
    ro = (np.array([0.0, 0.0, 5.0]) + 0.3 * rng.standard_normal((*shape, 3))).astype(np.float32)
    target = np.concatenate([rng.uniform(-1.5, 1.5, (*shape, 2)), np.zeros((*shape, 1))], axis=-1)
    rd = target - ro
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def jax_v3(a):
    """An (..., 3) numpy array as the JAX package's V3."""
    return JV(*(jnp.asarray(a[..., k]) for k in range(3)))


def torch_v3(a, requires_grad: bool = False):
    """An (..., 3) numpy array as the port's V3 of CPU tensors."""
    import torch

    return TV(*(torch.from_numpy(np.ascontiguousarray(a[..., k])).requires_grad_(requires_grad)
                for k in range(3)))


def voxels_to_torch(jvox):
    """A JAX ``Voxels`` as the port's (numpy in between)."""
    import torch

    return st.Voxels(**{k: torch.from_numpy(np.array(getattr(jvox, k), np.float32))
                        for k in ("values", "colors", "vmin", "vmax")})


def voxels_to_jax(tvox):
    """The port's ``Voxels`` as the JAX package's (numpy in between)."""
    return sk.Voxels(**{k: jnp.asarray(getattr(tvox, k).detach().cpu().numpy())
                        for k in ("values", "colors", "vmin", "vmax")})


# -- contracts between two programs -------------------------------------------
#
# The port's plain path evaluates op by op in IEEE float32. The JAX jnp path
# runs under jit, where XLA contracts a*b+c into FMAs and rewrites x/C as
# x*(1/C); the CUDA kernel contracts FMAs too. The 40 compounding steps turn
# those ulps into relative depth drift on silhouette-grazing rays, and the
# eps=1e-5 central-difference normal turns a 1-ulp distance difference into
# ~1e-2 relative noise on a hit pixel's shading. So two programs are held to
# these contracts, not to per-pixel equality.


def assert_depth_close(a, b):
    """Relative depth error at most 1e-3 everywhere, median at most 1e-5
    (miss rays reach ~1e12, so the error is relative)."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    assert err.max() <= 1e-3, float(err.max())
    assert np.median(err) <= 1e-5, float(np.median(err))


def assert_rgb_close(a, b):
    """Small frames: max |diff| below 2e-2, median at most 1e-4."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    assert d.max() < 2e-2, float(d.max())
    assert np.median(d) <= 1e-4, float(np.median(d))


FAR = 16.0  # from here on the normal's eps (1e-5) spans under 6 ulps of the position


def assert_rgb_close_but_far(a, b, depth):
    """ROADMAP C.15: RGB of a frame with rays that end far away, where the
    eps=1e-5 central-difference normal spans a few ulps of the position and
    two programs' float32 roundings give different normals. The median as
    ``assert_rgb_close``; the pixels at or beyond its 2e-2 are at most 1% of
    the frame and all at ``depth`` (the port's) ``FAR`` or more."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    depth = np.asarray(depth)
    assert np.median(d) <= 1e-4, float(np.median(d))
    off = d.max(axis=-1) >= 2e-2
    print(f"{int(off.sum())} of {off.size} pixels at or beyond 2e-2 (max {float(d.max()):.4g}), "
          f"at depths {np.sort(depth[off]).round(1).tolist()}")
    assert off.sum() <= 0.01 * off.size, int(off.sum())
    assert (depth[off] >= FAR).all(), depth[off]


def assert_distributional(a, b):
    """tests/test_goldens.py:66-68: median |diff| <= 5e-3, at most 0.5% of
    pixels off by more than 1e-2 and 0.1% by more than 5e-2."""
    d = np.abs(np.asarray(a) - np.asarray(b))
    px = d.max(axis=-1)
    n = px.size
    assert np.median(d) <= 5e-3, float(np.median(d))
    assert (px > 1e-2).sum() <= 0.005 * n, int((px > 1e-2).sum())
    assert (px > 5e-2).sum() <= 0.001 * n, int((px > 5e-2).sum())
