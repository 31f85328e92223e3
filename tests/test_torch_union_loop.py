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
plain path at ``test_torch_kernel_bwd_host.py``'s tolerances. The large
tier's adjoints (``sdf_dist_vjp``, ``sdf_dist_vjp_pair``, ``sdf_eval_vjp``)
pull the union back as a loop too: they are held bit for bit to the
straight-line adjoints at seeded points (lanes that take part and lanes
that go along), the tie rule's halved cotangents are checked by value, and
the 64x36 frame's gradients through the host kernels of all three backward
families are the straight-line form's bit for bit. The rest is when the
form engages: never in the small tier, whose source is the same as before
the loop form, nor for unlike children or a slot table that is not affine;
and the adjoints keep the straight-line form, source and all, in a large
program without a loop or whose union shares a node with the rest of the
scene.
"""

import ctypes
import dataclasses
import hashlib
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
from sdfkit_tpu_torch.utils.camera import camera_rays
from test_torch_kernel_host import SHIM, _gxx
from torch_host import _image_args, _ray_args, host_libraries, host_library, patch_kernels

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


# Each point's three adjoints, each adding to a row of its own: per point
# the distance and the point's gradient of sdf_dist_vjp, both points'
# gradients of sdf_dist_vjp_pair (with the next point), and sdf_eval_vjp's
# distance and point gradient; then the three rows of parameter sums.
VJPS = """
extern "C" void scene_vjps(const float* P, const float* pts, int n, float u, float g,
                           const float* cot, float* out, float* rows) {
  for (int i = 0; i < n; ++i) {
    const float* p = pts + 3 * i;
    const float* q = pts + 3 * ((i + 1) % n);
    const float* c = cot + 4 * i;
    float* o = out + 14 * i;
    float* r = rows + (long long)3 * i * SDF_N_PARAMS;
    o[0] = sdf_dist_vjp(p[0], p[1], p[2], P, u, g, o + 1, o + 2, o + 3, r);
    sdf_dist_vjp_pair(p[0], p[1], p[2], q[0], q[1], q[2], P, u, g, o + 4, o + 5, o + 6,
                      o + 7, o + 8, o + 9, r + SDF_N_PARAMS);
    o[10] = sdf_eval_vjp(p[0], p[1], p[2], P, c[0], c[1], c[2], c[3], o + 11, o + 12, o + 13,
                         r + 2 * SDF_N_PARAMS);
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
    bits = np.dtype(f"u{a.dtype.itemsize}")
    np.testing.assert_array_equal(a.view(bits)[~nan], b.view(bits)[~nan])


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


def _straight_adjoint(prog):
    """The adjoints of ``prog`` in the straight-line form: its loops dropped."""
    return sc.emit_large_vjp_cpp(dataclasses.replace(prog, loops=()))


@pytest.fixture(scope="module")
def both_adjoints(tmp_path_factory):
    """name -> (program, params, scene_vjps of the loop form, of the
    straight-line form)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the scene's adjoints")
    build_dir = tmp_path_factory.mktemp("union_loop_vjp")
    cache = {}

    def get(name):
        if name not in cache:
            expr = SCENES[name][0]()
            with pytest.MonkeyPatch.context() as mp:  # every union of like children a loop
                mp.setattr(sc, "LOOP_MIN_CHILDREN", 2)
                prog = sc.trace(expr)
            fns = []
            for form, adjoint in (("loop", prog.adjoint_source),
                                  ("straight", _straight_adjoint(prog))):
                src = build_dir / f"{name}_{form}.cc"
                src.write_text(SHIM + prog.source + adjoint + VJPS)
                fn = _gxx(src, src.with_suffix(".so"), "-O0").scene_vjps
                fn.restype = None
                fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_float] * 2
                               + [ctypes.c_void_p] * 3)
                fns.append(fn)
            params = sc.flat_params(expr).detach().contiguous().numpy()
            cache[name] = (prog, params, *fns)
        return cache[name]

    return get


def _adjoints(fn, params, pts, u, g, cot):
    """(per point: distances and point gradients, 14 floats; per point the
    three adjoints' rows of parameter sums)."""
    out = np.zeros((len(pts), 14), np.float32)
    rows = np.zeros((len(pts), 3, params.size), np.float32)
    fn(params.ctypes.data, pts.ctypes.data, len(pts), u, g, cot.ctypes.data, out.ctypes.data,
       rows.ctypes.data)
    return out, rows


@pytest.mark.parametrize("u", [1.0, 0.0], ids=["takes_part", "goes_along"])
@pytest.mark.parametrize("name", list(SCENES))
def test_adjoints_of_the_loop_form_are_the_tree_bit_for_bit(both_adjoints, name, u):
    """The three large-tier adjoints of the loop form (one child's pullback
    per child of least distance; the tree's rule at a tie) against the
    straight-line adjoints of the same program, bit for bit: every point's
    distance, point gradients and row of parameter sums, at the seeded,
    centre and surface points of ``_points`` that are finite (the ties
    scene's coincident children give exact ties at every point nearest
    them), with the distance's seed u = 1 and with u = 0, a lane that goes
    along and adds nothing."""
    prog, params, loop, straight = both_adjoints(name)
    _, children, table = SCENES[name]
    assert sc._adjoint_loops(prog) == prog.loops
    assert "sdf_tree_share" in prog.adjoint_source
    pts = _points(params, children if table else 0, seed=len(name))
    pts = np.ascontiguousarray(pts[np.isfinite(pts).all(axis=1)][::4 if children > 100 else 1])
    cot = np.random.default_rng(len(name)).normal(size=(len(pts), 4)).astype(np.float32)
    got, got_rows = _adjoints(loop, params, pts, u, 0.75, cot)
    want, want_rows = _adjoints(straight, params, pts, u, 0.75, cot)
    assert np.count_nonzero(want_rows) > len(pts)
    _assert_same_bits(got, want)
    _assert_same_bits(got_rows, want_rows)
    if u == 0.0:  # the distance's adjoints add nothing; the colour's seeds are cot's
        assert not want_rows[:, :2].any() and not want[:, 1:10].any()


def test_ties_halve_the_distance_cotangent(both_adjoints):
    """At a point nearest two coincident children (sphere 3 of the ties
    scene and its copy, children 4 and 5, paired by the tree) the tree's
    ``min`` halves the distance's cotangent: each copy's radius takes -g/2
    and its centre half the gradient, in both forms; the colour's goes whole
    to the last of them (``da < db ? a : b``)."""
    prog, params, loop, straight = both_adjoints("ties")
    pts = np.array([[-1.0, -2.0, 0.3], [-0.6, -2.0, 0.0]], np.float32)
    cot = np.array([[1.0, 2.0, 3.0, 0.0]] * 2, np.float32)
    for fn in (loop, straight):
        out, rows = _adjoints(fn, params, pts, 1.0, 2.0, cot)
        for i, normal in enumerate(([0.0, 0.0, 1.0], [1.0, 0.0, 0.0])):
            dist, colour = rows[i, 0].reshape(-1, 7), rows[i, 2].reshape(-1, 7)
            np.testing.assert_array_equal(np.flatnonzero(dist.any(axis=1)), [4, 5])
            np.testing.assert_array_equal(dist[4], dist[5])
            np.testing.assert_allclose(dist[4, 0], -1.0, rtol=1e-6)  # g * (-1) / 2
            np.testing.assert_allclose(dist[4, 4:], -np.float32(normal), atol=1e-6)
            np.testing.assert_allclose(out[i, 1:4], normal, atol=1e-6)  # u times the whole
            np.testing.assert_array_equal(np.flatnonzero(colour.any(axis=1)), [5])
            np.testing.assert_array_equal(colour[5, 1:4], [1.0, 2.0, 3.0])


@pytest.fixture(scope="module")
def frame_libs(tmp_path_factory):
    """The 200-sphere union's host library of every kernel family with the
    loop form's adjoints, and with the straight-line form's."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    prog = sc.compile_scene(union_grid_scene())
    straight = dataclasses.replace(prog, adjoint_source=_straight_adjoint(prog),
                                   adjoint_hash=prog.adjoint_hash + "_straight")
    build_dir = tmp_path_factory.mktemp("union_loop_frame")
    return {"loop": host_library(build_dir, prog), "straight": host_library(build_dir, straight)}


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
def test_frame_gradients_of_both_forms_agree_bit_for_bit(frame_libs, want_color):
    """The 200-sphere union at 64x36x40 from the default camera, a seeded
    cotangent pulled back through the host build of each backward family
    (the image backward, the store-fed backward on the forward's depth
    history, the ray-batch backward on the frame's rays) with the loop
    form's adjoints and with the straight-line form's: the parameters' and
    view's sums (float64 over the pixels' float32 rows) and the rays'
    cotangents agree bit for bit."""
    expr = union_grid_scene()
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(64, 36)
    n = cfg.width * cfg.height
    params = sc.flat_params(expr).detach().contiguous()
    v19 = rk.view19(view, cfg)
    ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far)
    rays = [c.contiguous().reshape(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    grad = torch.rand((n, 3) if want_color else (n,), generator=torch.Generator().manual_seed(9))
    image_args = (params.data_ptr(), v19.data_ptr(), *_image_args(cfg, 0, n, want_color))
    got = {}
    for form, lib in frame_libs.items():
        image, fed = (np.empty(params.numel() + 19) for _ in range(2))
        lib.raymarch_bwd_host(*image_args, grad.data_ptr(), image.ctypes.data)
        frame, store = torch.empty((n, 3) if want_color else (n,)), torch.empty((cfg.depth_iterations, n))
        lib.raymarch_fwd_store_host(*image_args, frame.data_ptr(), store.data_ptr())
        lib.raymarch_bwd_store_host(*image_args, grad.data_ptr(), store.data_ptr(), fed.ctypes.data)
        g_rays, batch = torch.empty((6, n)), np.empty(params.numel())
        lib.raymarch_rays_bwd_host(params.data_ptr(), *_ray_args(rays, cfg, want_color),
                                   grad.data_ptr(), None, g_rays.data_ptr(), None,
                                   batch.ctypes.data)
        got[form] = (image, fed, g_rays.numpy(), batch)
    for a, b in zip(got["loop"], got["straight"]):
        assert np.count_nonzero(b) > 100
        _assert_same_bits(a, b)


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


def _unlike():
    """A large union of 40 spheres and boxes in turn."""
    t = union_grid_table(40, seed=4)
    return balanced_union([
        _sphere(r, c, o) if k % 2 == 0 else st.box(float(r)).translate(*map(float, o))
        for k, (r, c, o) in enumerate(zip(t["radius"], t["color"], t["offset"]))])


def _onion(n=60):
    """``n`` concentric coloured spheres: like children that share the
    point's length among them."""
    rng = np.random.default_rng(7)
    return balanced_union([st.sphere(float(r), color=tuple(map(float, c))) for r, c in
                           zip(np.sort(rng.uniform(0.3, 3.0, n)), rng.uniform(0.0, 1.0, (n, 3)))])


def test_unlike_children_take_no_loop():
    """A large union of spheres and boxes in turn has no two like children
    under one union: no loop, and the source is the straight-line form."""
    prog = sc.trace(_unlike())
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


@pytest.mark.parametrize("name, hashes", [
    ("unlike", ("4e6613a251c72692", "f77d4974a8f18128")),
    ("below_threshold", ("41de8c5909e1ed01", "78e2b5c666a6b863")),
    ("union_grid", ("2a58b94728d53f6e", "231d6f306546a5ea")),
])
def test_large_tier_sources_the_adjoints_loop_form_leaves_alone(name, hashes):
    """The hashes of the source and of the source with its adjoints that the
    compiler wrote before the adjoints took the loop form: a large program
    without a loop (unlike children; 47 like ones, under
    ``LOOP_MIN_CHILDREN``) keeps both, so its libraries are the same; the
    200-sphere union keeps its forward (every forward library and frame),
    and its adjoints with the loop dropped, the form the loop form is held
    to bit for bit, are those it had."""
    expr = {"unlike": _unlike, "below_threshold": lambda: union_grid_scene(47),
            "union_grid": union_grid_scene}[name]()
    prog = sc.trace(expr)
    assert prog.large and bool(prog.loops) == (name == "union_grid")
    straight = _straight_adjoint(prog)
    digest = hashlib.sha256((prog.source + straight).encode()).hexdigest()[:16]
    assert (prog.hash, digest) == hashes
    if name == "union_grid":
        assert prog.adjoint_source != straight and "sdf_tree_share" in prog.adjoint_source
    else:
        assert (prog.hash, prog.adjoint_hash) == hashes and prog.adjoint_source == straight


def test_a_union_sharing_a_node_keeps_the_straight_line_adjoint():
    """Concentric spheres share the point's length among themselves, which
    their loop's pullback recomputes per child. Next to a sphere outside the
    union, which reads that shared length too, a cotangent would reach the
    union's nodes from outside: the forward keeps its loop, and the adjoints
    the straight-line form (``_adjoint_loops``)."""
    alone = sc.trace(_onion())
    assert sc._adjoint_loops(alone) == alone.loops != ()
    prog = sc.trace(_onion() | (st.sphere(0.2, color=(1.0, 0.0, 0.0)) & st.sphere(0.25)))
    assert prog.large and prog.looped[0] == 60 and sc._adjoint_loops(prog) == ()
    assert prog.adjoint_source == _straight_adjoint(prog)
    assert "sdf_tree_share" not in prog.adjoint_source


def test_the_counters_read_the_cover():
    """``Program.looped`` reads 200 children and nearly all the distance's
    nodes on the union grid, (0, 0.0) on the small scenes; ``LOOPED``
    counts the traced programs that took a loop."""
    prog = sc.compile_scene(union_grid_scene())
    assert prog.looped[0] == 200 and 0.99 < prog.looped[1] < 1.0
    for expr in (sphere_repeat_scene(), union_grid_scene(4)):
        assert sc.compile_scene(expr).looped == (0, 0.0)
    traces, looped, adjoints = sc.TRACES, sc.LOOPED, sc.LOOPED_ADJOINTS
    # Structures no other test traces: the fewest spheres that take a loop, moved; 3 moved
    # (24 slots: the small tier)
    sc.compile_scene(union_grid_scene(sc.LOOP_MIN_CHILDREN).translate(0.0, 0.0, 0.5))
    sc.compile_scene(union_grid_scene(3).translate(0.0, 0.0, 0.5))
    assert (sc.TRACES - traces, sc.LOOPED - looped) == (2, 1)
    # LOOPED_ADJOINTS counts the programs whose adjoints took the loop form too.
    assert sc.LOOPED_ADJOINTS - adjoints == 1


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
