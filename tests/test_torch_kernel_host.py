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
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params

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


def _gxx(src: pathlib.Path, so: pathlib.Path):
    subprocess.run(
        ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", "-I", str(CSRC), "-o", str(so), str(src)],
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
