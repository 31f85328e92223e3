"""The loop form of a union of like children (``sdf/compile.py``
``UnionLoop``), on the host.

In a program of the large tier the scene compiler writes a tree of unions
whose children differ only in their parameters as one loop over the
children, one child's code reading child k's slot j at ``base + stride*k +
j``. Here ``sdf_dist`` and ``sdf_eval`` of the loop form are compiled with
g++ beside the straight-line form of the same program (its loops dropped)
and held to it bit for bit at seeded points, on the surfaces, at exact ties
between coincident children and at NaN and infinite points; then the frame
and gradients at 64x36 through the kernels' per-pixel code go against the
plain path at ``test_torch_kernel_bwd_host.py``'s tolerances. The rest is
when the form engages: never in the small tier, whose source is the same
as before the loop form, nor for unlike children or a slot table that is
not affine.
"""

import ctypes
import dataclasses
import shutil

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import (
    RenderConfig,
    render_depth_image_torch,
    render_image_torch,
)
from sdfkit_tpu_torch.scenes import (
    balanced_union,
    sphere_repeat_scene,
    union_grid_scene,
    union_grid_table,
)
from sdfkit_tpu_torch.sdf import compile as sc
from test_torch_kernel_bwd_host import assert_grads_close, port_grads
from test_torch_kernel_host import SHIM, _gxx
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
st.set_default_device("cpu")

POINTS = """
extern "C" void scene_points(const float* P, const float* x, const float* y, const float* z,
                             int n, float* out) {
  for (int i = 0; i < n; ++i) {
    float r, g, b;
    out[5 * i] = sdf_dist(x[i], y[i], z[i], P);
    out[5 * i + 1] = sdf_eval(x[i], y[i], z[i], P, &r, &g, &b);
    out[5 * i + 2] = r;
    out[5 * i + 3] = g;
    out[5 * i + 4] = b;
  }
}
"""


def _sphere(r, c, o):
    return st.sphere(float(r), color=tuple(map(float, c))).translate(*map(float, o))


def _ties():
    """A union of 55 spheres in which every third sphere of a 40-sphere grid
    is followed by a copy of itself in another colour, and the first is
    copied once more at the end: exact ties, whichever way the tree pairs
    them. Radii 0.5 and whole-number centres, so that a point on a surface
    on an axis is at distance exactly 0."""
    prims = []
    for k in range(40):
        centre = (float(k % 8) - 4.0, float(k // 8) - 2.0, 0.0)
        prims.append(_sphere(0.5, (0.9, 0.1, 0.02 * k), centre))
        if k % 3 == 0:
            prims.append(_sphere(0.5, (0.1, 0.9, 0.02 * k), centre))
    prims.append(_sphere(0.5, (0.3, 0.3, 0.3), (-4.0, -2.0, 0.0)))
    return balanced_union(prims)


def _nested():
    """30 like children, each a translated union of two spheres: a loop of
    two inside the loop of 30."""
    t = union_grid_table(60, seed=3)
    return balanced_union([
        (_sphere(t["radius"][2 * k], t["color"][2 * k], (0.0, 0.0, 0.0))
         | _sphere(t["radius"][2 * k + 1], t["color"][2 * k + 1], (0.3, 0.0, 0.0)))
        .translate(*map(float, t["offset"][2 * k]))
        for k in range(30)])


def _inside():
    """The loop inside a larger scene: the 50-sphere grid moved, between a
    plane and a box that are unlike it."""
    grid = union_grid_scene(50, seed=2).translate(0.1, 0.2, 0.3)
    return st.plane_xz(-2.0, color=(0.4, 0.4, 0.4)) | grid | st.box(0.3).translate(0.0, 0.0, 1.5)


# name -> (scene, children of its loop, whether its slots are 7 a sphere from 0)
SCENES = {
    "grid200": (union_grid_scene, 200, True),
    "grid201": (lambda: union_grid_scene(201), 201, True),  # the balanced tree is ragged
    "ties": (_ties, 55, True),
    "nested": (_nested, 30, False),
    "inside": (_inside, 50, False),
}


@pytest.fixture(scope="module")
def both_forms(tmp_path_factory):
    """name -> (program, params, loop form's scene_points, straight-line form's)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the scene's functions")
    build_dir = tmp_path_factory.mktemp("union_loop")
    cache = {}

    def get(name):
        if name not in cache:
            expr = SCENES[name][0]()
            with pytest.MonkeyPatch.context() as mp:  # every union of like children a loop
                mp.setattr(sc, "LOOP_MIN_CHILDREN", 2)
                prog = sc.trace(expr)
            fns = []
            for form, source in (("loop", prog.source),
                                 ("straight", sc.emit_cpp(dataclasses.replace(prog, loops=())))):
                src = build_dir / f"{name}_{form}.cc"
                src.write_text(SHIM + source + POINTS)
                fn = _gxx(src, src.with_suffix(".so"), "-O0").scene_points
                fn.restype = None
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_void_p]
                fns.append(fn)
            params = sc.flat_params(expr).detach().contiguous().numpy()
            cache[name] = (prog, params, *fns)
        return cache[name]

    return get


def _evaluate(fn, params, pts):
    pts = np.ascontiguousarray(pts, np.float32)
    x, y, z = (np.ascontiguousarray(pts[:, k]) for k in range(3))
    out = np.empty((len(pts), 5), np.float32)
    fn(params.ctypes.data, x.ctypes.data, y.ctypes.data, z.ctypes.data, len(pts),
       out.ctypes.data)
    return out


def _points(params, spheres, seed):
    """Seeded points over the scenes; each of the first ``spheres`` spheres'
    centre and the points a radius from it along each axis (its surface);
    and points with NaN, infinite and signed-zero coordinates."""
    rng = np.random.default_rng(seed)
    pts = [rng.uniform((-7.0, -4.0, -2.5), (7.0, 4.0, 2.5), (4096, 3))]
    table = params[:7 * spheres].reshape(spheres, 7)
    centres, radii = table[:, 4:7], table[:, :1]
    pts.append(centres)
    for axis in range(3):
        step = np.zeros(3, np.float32)
        step[axis] = 1.0
        pts += [centres + radii * step, centres - radii * step]
    special = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0]
    pts.append(np.array([(a, b, c) for a in special for b in special for c in special]))
    return np.concatenate(pts).astype(np.float32)


def _assert_same_bits(a, b):
    """Equal bits, or NaN in both (a NaN's payload is not held)."""
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.uint32)[~nan], b.view(np.uint32)[~nan])


@pytest.mark.parametrize("name", list(SCENES))
def test_loop_form_is_the_tree_bit_for_bit(both_forms, name):
    """``sdf_dist`` and ``sdf_eval`` (distance and colour) of the loop form
    against the straight-line form of the same program, bit for bit: at
    seeded points, each child's centre and surface points, and at NaN,
    infinite and signed-zero coordinates. The ragged tree of 201, exact
    ties, a loop in a loop and a loop inside an unlike scene included."""
    prog, params, loop, straight = both_forms(name)
    _, children, table = SCENES[name]
    assert prog.large and prog.loops and prog.looped[0] == children
    pts = _points(params, children if table else 0, seed=len(name))
    got, want = _evaluate(loop, params, pts), _evaluate(straight, params, pts)
    assert np.isfinite(want[:4096]).all()
    _assert_same_bits(got, want)


def test_ties_go_to_the_last_child(both_forms):
    """At a tie the tree's ``da < db ? a : b`` takes the right child, so the
    last of the coincident children gives the colour, in both forms; on a
    surface point the distance is exactly 0. At a NaN point the distance is
    NaN and the colour the last child's."""
    prog, params, loop, straight = both_forms("ties")
    pts = np.array([[-4.0, -2.0, 0.0], [-3.5, -2.0, 0.0], [-1.0, -2.0, 0.0],
                    [np.nan, 0.0, 0.0]], np.float32)
    for fn in (loop, straight):
        out = _evaluate(fn, params, pts)
        np.testing.assert_array_equal(out[0, 2:], np.float32([0.3, 0.3, 0.3]))  # the last copy
        np.testing.assert_array_equal(out[1, :2], [0.0, 0.0])
        assert np.signbit(out[1, 0]) == np.signbit(out[1, 1]) == False  # noqa: E712
        np.testing.assert_array_equal(out[2, 2:], np.float32([0.1, 0.9, 0.02 * 3]))  # 3's copy
        assert np.isnan(out[3, :2]).all()
        np.testing.assert_array_equal(out[3, 2:], np.float32([0.3, 0.3, 0.3]))


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("union_loop_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_frame_and_gradients_at_64x36(host_kernels, want_color):
    """The 200-sphere union at 64x36x40 from the default camera through the
    kernels' per-pixel code (the loop form in the march, the taps and the
    colour step) against the plain path: the frame under ``torch_parity``'s
    contract, every leaf's and the view's gradient at C.3's tolerances for
    two programs. Depth too: its misses reach 1e12 and the view's entries
    are sums over the frame that cancel to 1e-8 of the largest, so the two
    sums' orders part them by more than the tolerance of one program."""
    expr = union_grid_scene()
    assert sc.compile_scene(expr).loops
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(64, 36)
    with torch.no_grad():
        if want_color:
            tp.assert_rgb_close(rk.render_image_kernel(expr, view, cfg).numpy(),
                                render_image_torch(expr, view, cfg).numpy())
        else:
            tp.assert_depth_close(rk.render_depth_image_kernel(expr, view, cfg).numpy(),
                                  render_depth_image_torch(expr, view, cfg).numpy())
    got = port_grads(expr, view, cfg, want_color, "kernel")
    assert host_kernels["bwd"] == 1
    assert_grads_close(got, port_grads(expr, view, cfg, want_color, "torch"))


def test_unlike_children_take_no_loop():
    """A large union of spheres and boxes in turn has no two like children
    under one union: no loop, and the source is the straight-line form."""
    t = union_grid_table(40, seed=4)
    prims = [_sphere(r, c, o) if k % 2 == 0 else st.box(float(r)).translate(*map(float, o))
             for k, (r, c, o) in enumerate(zip(t["radius"], t["color"], t["offset"]))]
    prog = sc.trace(balanced_union(prims))
    assert prog.large and prog.loops == () and prog.looped == (0, 0.0)
    assert prog.source == sc.emit_cpp(dataclasses.replace(prog, loops=()))
    assert "for (" not in prog.source


def test_slot_table_must_be_affine():
    """The children's first slots must lie one stride apart."""
    assert sc._slot_table([0, 7, 14, 21], 7) == 0
    assert sc._slot_table([5, 12, 19], 7) == 5
    assert sc._slot_table([0, 7, 15], 7) is None
    assert sc._slot_table([0, 7, 14], 6) is None


@pytest.mark.parametrize("name, hashes", [
    ("sphere_repeat", ("ff49cfdc0a65ea1c", "2ef54f456167ae6b")),
    ("union_grid_4", ("dbbf7b1a59d628bc", "e86119e4320bfc63")),
])
def test_small_tier_source_is_unchanged(name, hashes):
    """The small tier takes no loop: SphereRepeat's and the 4-sphere union's
    sources, and so their libraries, are those the compiler wrote before
    the loop form (the hashes of that source and of it with its adjoint)."""
    expr = sphere_repeat_scene() if name == "sphere_repeat" else union_grid_scene(4)
    prog = sc.trace(expr)
    assert not prog.large and prog.loops == () and prog.looped == (0, 0.0)
    assert (prog.hash, prog.adjoint_hash) == hashes


def test_the_counters_read_the_cover():
    """``Program.looped`` reads 200 children and nearly all the distance's
    nodes on the union grid, (0, 0.0) on the small scenes; ``LOOPED``
    counts the traced programs that took a loop."""
    prog = sc.compile_scene(union_grid_scene())
    assert prog.looped[0] == 200 and 0.99 < prog.looped[1] < 1.0
    for expr in (sphere_repeat_scene(), union_grid_scene(4)):
        assert sc.compile_scene(expr).looped == (0, 0.0)
    traces, looped = sc.TRACES, sc.LOOPED
    # Structures no other test traces: the fewest spheres that take a loop, moved; 3 moved
    # (24 slots: the small tier)
    sc.compile_scene(union_grid_scene(sc.LOOP_MIN_CHILDREN).translate(0.0, 0.0, 0.5))
    sc.compile_scene(union_grid_scene(3).translate(0.0, 0.0, 0.5))
    assert (sc.TRACES - traces, sc.LOOPED - looped) == (2, 1)


def test_fewer_children_than_the_threshold_take_no_loop():
    """A large union of like children takes the loop form from
    ``LOOP_MIN_CHILDREN`` children on, and below it the straight-line form
    (its forward measured faster there); only a program with a loop has the
    kernels stage its parameters in shared memory."""
    n = sc.LOOP_MIN_CHILDREN
    looped = sc.trace(union_grid_scene(n))
    assert looped.looped[0] == n and "#define SDF_SHARED_PARAMS 1" in looped.source
    fewer = sc.trace(union_grid_scene(n - 1))
    assert fewer.large and fewer.loops == () and "for (" not in fewer.source
    assert "SDF_SHARED_PARAMS" not in fewer.source
    # Past SHARED_PARAMS_MAX_SLOTS the loop reads the parameters where they are.
    many = sc.trace(union_grid_scene(sc.SHARED_PARAMS_MAX_SLOTS // 7 + 1))
    assert many.loops and "SDF_SHARED_PARAMS" not in many.source
