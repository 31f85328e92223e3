"""The CUDA kernel's per-pixel code and the C++ emitter, compiled for the host.

The kernel itself runs only on the GPU, but ``csrc/raymarch_fwd.cuh`` holds
host-and-device code with no CUDA header. Here it is compiled with g++
together with a scene the compiler emitted, a small shim that defines the
CUDA qualifiers away, and a host loop over the pixels; the library is loaded
with ctypes and compared with the port's plain path. Both evaluate in IEEE
float32 without FMA contraction (g++ for baseline x86-64 emits no FMA), so
depth holds at rtol 1e-4; RGB, where a single flipped silhouette pixel may
differ by O(1), is held to the distributional contract.
"""

import ctypes
import pathlib
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch import scenes
from sdfkit_tpu_torch.io.png import read_png
from sdfkit_tpu_torch.render.cuda.raymarch_kernel import view19
from sdfkit_tpu_torch.render.raymarch import (
    RenderConfig,
    render_depth_image_torch,
    render_image_torch,
)
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params, run
from sdfkit_tpu_torch.utils.v3 import V3

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

CSRC = pathlib.Path(st.__file__).parent / "csrc"
GOLDEN_DIR = pathlib.Path(__file__).parent / "goldens"

SHIM = """\
#include <math.h>
#define __host__
#define __device__
#define __forceinline__ inline
"""

LOOP = """
#include "raymarch_fwd.cuh"

extern "C" void raymarch_fwd_host(const float* P, const float* view19, int width,
                                  int height, int pix0, int local_npix, int iters,
                                  float depth0, float near_, float far_, int want_color,
                                  float* out) {
  RenderArgs a{width, height, pix0, local_npix, iters, depth0, near_, far_};
  for (int i = 0; i < local_npix; ++i) {
    if (want_color) shade_pixel<true>(pix0 + i, P, view19, a, out);
    else shade_pixel<false>(pix0 + i, P, view19, a, out);
  }
}
"""


def _gxx(src: pathlib.Path, so: pathlib.Path, opt: str = "-O2"):
    subprocess.run(
        ["g++", opt, "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(src)],
        check=True, capture_output=True, timeout=120,
    )
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """program -> the host-built raymarch_fwd_host of that scene."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel body")
    build_dir = tmp_path_factory.mktemp("kernel_host")
    libs = {}

    def get(program):
        if program.hash not in libs:
            src = build_dir / f"scene_{program.hash}.cc"
            src.write_text(SHIM + program.source + LOOP)
            fn = _gxx(src, src.with_suffix(".so")).raymarch_fwd_host
            fn.restype = None
            fn.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_float] * 3
                           + [ctypes.c_int, ctypes.c_void_p])
            libs[program.hash] = fn
        return libs[program.hash]

    return get


def host_render(get, expr, view, cfg, want_color, pix0=0, local_npix=None):
    if local_npix is None:
        local_npix = cfg.width * cfg.height
    fn = get(compile_scene(expr))
    params = flat_params(expr).detach().contiguous()
    v19 = view19(view, cfg)
    out = torch.empty((local_npix, 3) if want_color else (local_npix,))
    fn(params.data_ptr(), v19.data_ptr(), cfg.width, cfg.height, pix0, local_npix,
       cfg.depth_iterations, cfg.near - 0.1, cfg.near, cfg.far, int(want_color),
       out.data_ptr())
    return out.numpy()


def torch_render(expr, view, cfg, want_color):
    with torch.no_grad():
        fn = render_image_torch if want_color else render_depth_image_torch
        return fn(expr, view, cfg).numpy()


@pytest.mark.parametrize("name,make", [
    ("sphere", lambda: st.sphere(1.0)),
    ("box", lambda: st.box(1.0)),
    ("plane", lambda: st.plane_xy()),
])
def test_depth_goldens_through_the_kernel_body(host_kernel, name, make):
    cfg = RenderConfig(50, 30)
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    depth = host_render(host_kernel, make(), view, cfg, False).reshape(30, 50)
    golden = np.load(GOLDEN_DIR / f"{name}_depth_50x30.npy")
    np.testing.assert_allclose(depth, golden, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(depth, torch_render(make(), view, cfg, False), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["repeat_xy_plain", "repeat_xy", "repeat_indexed"])
def test_small_scenes_match_the_plain_path(host_kernel, name):
    _, expr = tp.build(name)
    cfg = RenderConfig(40, 24)
    view = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    depth = host_render(host_kernel, expr, view, cfg, False).reshape(24, 40)
    np.testing.assert_allclose(depth, torch_render(expr, view, cfg, False), rtol=1e-4)
    rgb = host_render(host_kernel, expr, view, cfg, True).reshape(24, 40, 3)
    ref = torch_render(expr, view, cfg, True)
    tp.assert_distributional(rgb, ref)
    tp.assert_rgb_close(rgb, ref)


def test_sphere_repeat_matches_plain_path_and_golden(host_kernel):
    expr = scenes.sphere_repeat_scene()
    cfg = RenderConfig(192, 108)
    view = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    rgb = host_render(host_kernel, expr, view, cfg, True).reshape(108, 192, 3)
    assert np.isfinite(rgb).all()
    tp.assert_distributional(rgb, torch_render(expr, view, cfg, True))
    tp.assert_distributional(np.clip(rgb, 0.0, 1.0), read_png(GOLDEN_DIR / "sphere_repeat_192x108.png"))


def test_pix0_renders_a_row_band(host_kernel):
    expr = scenes.sphere_repeat_scene()
    cfg = RenderConfig(40, 24)
    view = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    full = host_render(host_kernel, expr, view, cfg, True).reshape(24, 40, 3)
    band = host_render(host_kernel, expr, view, cfg, True, pix0=10 * 40, local_npix=5 * 40)
    np.testing.assert_array_equal(band.reshape(5, 40, 3), full[10:15])


def test_emitted_scene_code_for_every_node_type(tmp_path):
    """Every node type through the C++ emitter: one translation unit holds
    each scene in its own namespace, and sdf_eval is compared with the
    port's eval at 1024 seeded points."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    exprs = [tp.build(name, perturb_seed=5)[1] for name in tp.NAMES]
    parts = [SHIM]
    for i, expr in enumerate(exprs):
        parts.append(f"namespace s{i} {{\n{compile_scene(expr).source}}}\n")
        parts.append(
            f'extern "C" void eval_{i}(const float* P, const float* pts, int n, float* out) {{\n'
            f"  for (int k = 0; k < n; ++k) out[4 * k + 3] = s{i}::sdf_eval(pts[3 * k], "
            f"pts[3 * k + 1], pts[3 * k + 2], P, &out[4 * k], &out[4 * k + 1], &out[4 * k + 2]);\n"
            "}\n"
        )
    src = tmp_path / "all_scenes.cc"
    src.write_text("".join(parts))
    lib = _gxx(src, tmp_path / "all_scenes.so")
    pts = (np.random.default_rng(0).random((1024, 3)) * 6 - 3).astype(np.float32)
    for i, (name, expr) in enumerate(zip(tp.NAMES, exprs)):
        fn = getattr(lib, f"eval_{i}")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        params = flat_params(expr).detach().contiguous()
        out = np.empty((1024, 4), np.float32)
        fn(params.data_ptr(), pts.ctypes.data, 1024, out.ctypes.data)
        with torch.no_grad():
            ref = expr(torch.from_numpy(pts)).numpy()
        np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-6, err_msg=name)


def test_division_by_a_uniform_computes_the_plain_division(tmp_path):
    """The emitter writes ``x / c`` with a parameter-only ``c`` (a
    repetition's cell size) as a reciprocal taken once and two fused
    multiply-adds. The g++ build of ``sdf_dist`` and ``sdf_eval`` against the
    plain executor ``run``, which divides, at the tolerance of this module,
    and bit for bit against the g++ build of the same source with the
    division written back as ``/``. A parameter edit keeps both hashes."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    exprs = [tp.build(name, perturb_seed=5)[1] for name in tp.NAMES]
    parts = [SHIM]
    tail = re.compile(r"const float q(\d+) = (\w+) \* rc(\d+);\n\s*"
                      r"const float v\1 = fmaf\(fmaf\(-([^,]+), q\1, \2\), rc\3, q\1\);")
    for i, expr in enumerate(exprs):
        source = compile_scene(expr).source
        divided = tail.sub(r"const float v\1 = \2 / \4;", source)
        assert ("const float rc" in source) == (divided != source) and " * rc" not in divided
        for ns, text in ((f"s{i}", source), (f"d{i}", divided)):
            parts.append(f"namespace {ns} {{\n{text}}}\n")
        parts.append(
            f'extern "C" void both_{i}(const float* P, const float* pts, int n, float* out) {{\n'
            f"  for (int k = 0; k < n; ++k) {{\n"
            f"    const float x = pts[3 * k], y = pts[3 * k + 1], z = pts[3 * k + 2];\n"
            f"    float* o = out + 10 * k;\n"
            f"    o[3] = s{i}::sdf_eval(x, y, z, P, o, o + 1, o + 2);\n"
            f"    o[4] = s{i}::sdf_dist(x, y, z, P);\n"
            f"    o[8] = d{i}::sdf_eval(x, y, z, P, o + 5, o + 6, o + 7);\n"
            f"    o[9] = d{i}::sdf_dist(x, y, z, P);\n"
            "  }\n}\n"
        )
    src = tmp_path / "uniform.cc"
    src.write_text("".join(parts))
    lib = _gxx(src, tmp_path / "uniform.so")
    n = 4096
    rng = np.random.default_rng(2)
    pts = (rng.random((n, 3)) * 12 - 6).astype(np.float32)
    pts[: n // 4] = np.round(pts[: n // 4] * 2) / 2  # cell borders and centres of the default sizes
    hoisted = 0
    for i, (name, expr) in enumerate(zip(tp.NAMES, exprs)):
        program = compile_scene(expr)
        fn = getattr(lib, f"both_{i}")
        fn.restype = None
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        params = flat_params(expr).detach().contiguous()
        out = np.empty((n, 10), np.float32)
        fn(params.data_ptr(), pts.ctypes.data, n, out.ctypes.data)
        with torch.no_grad():
            color, dist = run(program, V3.from_array(torch.from_numpy(pts)), params)
            ref = np.stack([np.broadcast_to(np.asarray(c, np.float32), (n,))
                            for c in (color.x, color.y, color.z, dist)], -1)
        np.testing.assert_allclose(out[:, :4], ref, rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(out[:, 4], ref[:, 3], rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_array_equal(out[:, :5], out[:, 5:], err_msg=name)
        hoisted += "= 1.0f / " in program.source
        hashes = (program.hash, program.adjoint_hash)
        with torch.no_grad():
            for q in st.leaves(expr):
                q.mul_(1.25)
        edited = compile_scene(expr)
        assert (edited.hash, edited.adjoint_hash) == hashes, name
    assert hoisted >= 9  # every repetition divides by its cell size


def test_quotient_by_a_reciprocal_against_the_division(tmp_path):
    """The three lines the emitter writes for ``x / c`` with a uniform ``c``,
    taken verbatim from an emitted program and built with g++, against ``/``:
    equal on four million seeded pairs over ten binades either way, and on
    the 73,737 values within four ulps of every multiple of a cell size up to
    4096 cells, for every cell size a parity scene divides by (as built and
    perturbed) and a few more, wherever the quotient is a normal number. Where
    the two differ is pinned too. A subnormal quotient (``|x|`` under 1e-37
    times the cell) is off by up to one subnormal step, since the residual is
    no longer exact; for ``-2**-149 / 1.75`` that is -0 for the smallest negative
    number, whose floors are 0 and -1: the floor-mod then returns the other
    end of the same cell. A cell size of zero, infinity or a subnormal gives
    NaN; the division gives infinity or zero there, and the floor-mod NaN or a
    point far outside any scene."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the emitted code")
    lines = re.compile(r"const float (rc\d+) = 1\.0f / (\w+);\n\s*"
                       r"const float (q\d+) = (\w+) \* \1;\n\s*"
                       r"const float (v\d+) = fmaf\(fmaf\(-\2, \3, \4\), \1, \3\);")
    cells = {3.0, 0.1, 0.7, 1.3, 1e-3, 1e3}
    emitted = None
    for name, seed in ((name, seed) for name in tp.NAMES for seed in (None, 5)):
        expr = tp.build(name, perturb_seed=seed)[1]
        program = compile_scene(expr)
        params = flat_params(expr).detach().numpy()
        for i in program.eval_live:
            node = program.nodes[i]
            if node[0] == "div" and program.nodes[node[2]][0] == "param":
                cells.add(float(params[program.nodes[node[2]][1]]))
        emitted = emitted or lines.search(program.source)
    assert emitted is not None and len(cells) > 6
    c_name, x_name, out_name = emitted.group(2), emitted.group(4), emitted.group(5)
    src = tmp_path / "quotient.cc"
    src.write_text(SHIM + f"""
extern "C" void quotients(const float* xs, const float* cs, int n, float* got, float* want) {{
  for (int k = 0; k < n; ++k) {{
    const float {x_name} = xs[k], {c_name} = cs[k];
    {emitted.group(0)}
    got[k] = {out_name};
    volatile float x = xs[k], c = cs[k];
    want[k] = x / c;
  }}
}}
""")
    lib = _gxx(src, tmp_path / "quotient.so")
    lib.quotients.restype = None
    lib.quotients.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_void_p]

    def both(x, c):
        x = np.ascontiguousarray(x, np.float32)
        c = np.ascontiguousarray(np.broadcast_to(np.float32(c), x.shape))
        got, want = np.empty_like(x), np.empty_like(x)
        lib.quotients(x.ctypes.data, c.ctypes.data, x.size, got.ctypes.data, want.ctypes.data)
        return got, want

    rng = np.random.default_rng(3)
    n = 4_000_000
    x = (rng.standard_normal(n) * np.exp2(rng.uniform(-10, 10, n))).astype(np.float32)
    got, want = both(x, np.exp2(rng.uniform(-10, 10, n)).astype(np.float32))
    np.testing.assert_array_equal(got, want)
    for cell in sorted(cells):
        border = (np.arange(-4096, 4097) * np.float64(np.float32(cell))).astype(np.float32)
        near = [border]
        for toward in (np.float32(-np.inf), np.float32(np.inf)):
            step = border
            for _ in range(4):
                step = np.nextafter(step, toward)
                near.append(step)
        got, want = both(np.concatenate(near), cell)
        normal = np.abs(want) >= np.finfo(np.float32).tiny
        np.testing.assert_array_equal(got[normal], want[normal], err_msg=str(cell))
        assert np.all(np.abs(got[~normal] - want[~normal]) <= 2.0**-149), cell
    got, want = both(np.float32([2.0**-148, -(2.0**-149)]), np.float32([1.3, 1.75]))
    assert got.tolist() == [2.0**-149, -0.0] and want.tolist() == [2.0**-148, -(2.0**-149)]
    assert np.floor(got).tolist() == [0.0, -0.0] and np.floor(want).tolist() == [0.0, -1.0]
    for cell in (0.0, np.inf, 2.0**-130):
        got, want = both(np.float32([1.5, -2.5]), cell)
        assert np.all(np.isnan(got)) and not np.any(np.isnan(want)), cell
