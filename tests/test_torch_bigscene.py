"""The fitting-sized scene and the backward's large-scene tier, on the host.

``scenes.union_grid_scene`` (a balanced union of coloured spheres, seven
scalars each, 1,400 at 200 spheres) is built in both packages from one table
(``torch_parity.build``). Past ``LARGE_SCENE_SLOTS`` parameter slots the
scene compiler emits the large tier's adjoints (``emit_large_vjp_cpp``), which
``csrc/raymarch_bwd.cuh`` pulls back with no per-thread array whose length is
a number of slots. Here the kernels' per-pixel code is compiled with g++ and
stands in for the launches (``tests/torch_host.py``), as in
``test_torch_kernel_bwd_host.py``, whose tolerances (C.3) these tests take.

The JAX side runs op by op: its jit takes minutes on a tree of this size on
this CPU. So ``jax.grad`` is taken at 24 spheres, and at 200 the port's
gradient is held to autograd of its own plain path, which the JAX package's
frames hold at that size.
"""

import functools
import re
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch import ops
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.scenes import union_grid_scene, union_grid_table
from sdfkit_tpu_torch.sdf import compile as sc
from sdfkit_tpu_torch.sdf.expr import SdfExpr
from sdfkit_tpu_torch.utils.v3 import V3
import torch_host
from test_torch_kernel_bwd_host import assert_grads_close, port_grads
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
st.set_default_device("cpu")

VIEW = ((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))  # the default camera
SIZES = {"union_grid_24": (24, 16), "union_grid": (16, 8)}
# The JAX side marches fewer steps than 40: op by op, a step of the 200-sphere
# scene is 2,199 dispatches. Both programs march the same count, and a ray
# that hits a sphere facing the camera 5 away settles within it.
JAX_ITERATIONS = {"union_grid_24": 16, "union_grid": 8}
MIN_HIT_SHARE = {"union_grid_24": 0.05, "union_grid": 0.5}  # 24 spheres fill one row


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("bigscene_host"))


@pytest.fixture
def host_kernels(host_libs, monkeypatch):
    return patch_kernels(monkeypatch, host_libs)


@functools.lru_cache(maxsize=None)
def scene(name):
    return tp.build(name)


@functools.lru_cache(maxsize=None)
def jax_frames(name):
    """(depth, rgb) of the JAX package's jnp path, op by op."""
    from sdfkit_tpu.render import raymarch as jrm
    from sdfkit_tpu.utils.camera import camera_rays

    jexpr, _ = scene(name)
    w, h = SIZES[name]
    cfg = jrm.RenderConfig(width=w, height=h, depth_iterations=JAX_ITERATIONS[name])
    view = jnp.asarray(st.look_at(*VIEW).numpy())
    ro, rd = camera_rays(w, h, view, cfg.vfov_degrees, cfg.near, cfg.far)
    return (np.asarray(jrm.render_depth_rays(jexpr, ro, rd, cfg)),
            np.asarray(jrm.render_rays(jexpr, ro, rd, cfg)))


def test_union_grid_scene_is_the_table_in_union_tree_shape():
    """Seven scalars a sphere in leaf order radius, colour, offset, from
    the seeded table; a balanced union (``_union_tree``'s pairing) whose
    program has 1,400 slots, 800 of them read by the distance."""
    expr = union_grid_scene()
    t = union_grid_table()
    leaves = [p.detach().numpy() for p in st.leaves(expr)]
    assert len(leaves) == 600
    np.testing.assert_array_equal(np.stack(leaves[0::3]), t["radius"])
    np.testing.assert_array_equal(np.stack(leaves[1::3]), t["color"])
    np.testing.assert_array_equal(np.stack(leaves[2::3]), t["offset"])
    assert np.array_equal(union_grid_table(seed=0)["color"], t["color"])
    assert not np.array_equal(union_grid_table(seed=1)["color"], t["color"])
    prog = sc.compile_scene(expr)
    counts = sc.operation_counts(prog)
    assert (prog.n_params, counts["dist_slots"], prog.large) == (1400, 800, True)
    depth = 0
    node = expr
    while isinstance(node, st.sdf.Union):
        node, depth = node.a, depth + 1
    assert depth == 8  # ceil(log2(200))
    # The JAX package's copy carries the same values.
    jexpr, texpr = scene("union_grid")
    assert tp.jax_leaf_shapes(jexpr) == [tuple(p.shape) for p in st.leaves(texpr)]
    for a, b in zip(jax.tree_util.tree_leaves(jexpr), st.leaves(texpr)):
        np.testing.assert_array_equal(np.asarray(a), b.detach().numpy())


@pytest.mark.parametrize("name", ["union_grid_24", "union_grid"])
def test_frames_through_the_kernels_match_jax(host_kernels, name):
    """Depth and RGB through the kernels' per-pixel code against the JAX
    package's jnp path, under ``torch_parity``'s contract; at 200 spheres
    most of the frame is surface."""
    _, texpr = scene(name)
    w, h = SIZES[name]
    view = st.look_at(*VIEW)
    cfg = RenderConfig(w, h, depth_iterations=JAX_ITERATIONS[name])
    depth = rk.render_depth_image_kernel(texpr, view, cfg).detach().numpy()
    rgb = rk.render_image_kernel(texpr, view, cfg).detach().numpy()
    assert host_kernels["fwd"] == 2
    j_depth, j_rgb = jax_frames(name)
    tp.assert_depth_close(depth, j_depth)
    tp.assert_rgb_close(rgb, j_rgb)
    assert (depth <= 100.0).mean() > MIN_HIT_SHARE[name]


def test_gradient_at_24_spheres_matches_jax_grad(host_kernels):
    """``jax.grad`` of the summed squared render (jnp path, op by op, 16
    steps) against the port's gradient through the large tier's per-pixel
    code: every leaf and the view, C.3's bounds."""
    from test_torch_kernel_bwd_host import jax_grads

    jexpr, texpr = scene("union_grid_24")
    assert sc.compile_scene(texpr).large
    view = st.look_at(*VIEW)
    cfg = RenderConfig(*SIZES["union_grid_24"], depth_iterations=JAX_ITERATIONS["union_grid_24"])
    got = port_grads(texpr, view, cfg, True, "kernel")
    assert host_kernels["bwd"] == 1
    assert_grads_close(got, jax_grads(jexpr, view, cfg, True, "jnp"))


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("name", ["union_grid_24", "union_grid"])
def test_gradient_matches_the_plain_path(host_kernels, name, want_color):
    """Every leaf and the view through the large tier against autograd of
    the plain path: C.3's bounds (depth: the same IEEE program)."""
    _, texpr = scene(name)
    view = st.look_at(*VIEW)
    cfg = RenderConfig(*SIZES[name])
    got = port_grads(texpr, view, cfg, want_color, "kernel")
    assert host_kernels["bwd"] == 1
    assert_grads_close(got, port_grads(texpr, view, cfg, want_color, "torch"),
                       exact_program=not want_color)


def _tiers(monkeypatch, expr):
    """(small, large) programs of one scene: the tier threshold set above and
    below its slots."""
    monkeypatch.setattr(sc, "LARGE_SCENE_SLOTS", 10**6)
    small = sc.trace(expr)
    monkeypatch.setattr(sc, "LARGE_SCENE_SLOTS", 4)
    large = sc.trace(expr)
    assert (small.large, large.large) == (False, True)
    return small, large


def _three_spheres():
    """``_union_tree(3)`` of tests/test_pallas_kernel.py, coloured."""
    prims = [st.sphere(1.0, color=(0.9, 0.3 * k, 0.2)).translate(float(k), 0.0, 0.0)
             for k in range(3)]
    return (prims[0] | prims[1]) | prims[2]


@pytest.mark.parametrize("want_color", [True, False], ids=["rgb", "depth"])
@pytest.mark.parametrize("path", ["image", "store", "rays"])
def test_large_tier_equals_small_tier(host_kernels, monkeypatch, path, want_color):
    """The mirror of test_vmem_param_path_grads_match
    (tests/test_pallas_kernel.py): a 3-sphere union with the threshold
    monkeypatched down takes the large tier, and its gradient equals the
    small tier's (rtol 1e-5, atol 1e-6, the JAX test's) through the image
    backward, the store-fed one and the ray-batch one. The ray-batch
    backward of the large tier replays and sweeps each ray: it is held to
    the small tier's replay and sweep of the same rays (the tangent march
    associates the same sum the other way, 5e-5 apart on a ray that misses
    at depth 1e12)."""
    expr = _three_spheres()
    view = st.look_at((0.0, 0.0, 6.0), (1.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = RenderConfig(16, 8)
    out = []
    for k, prog in enumerate(_tiers(monkeypatch, expr)):  # the loaders give host libraries
        params = sc.flat_params(expr).detach().contiguous()
        v19 = rk.view19(view, cfg)
        npix = cfg.width * cfg.height
        gen = np.random.default_rng(3)
        cot = torch.from_numpy(gen.standard_normal((npix, 3) if want_color else npix)
                               .astype(np.float32))
        if path == "rays":
            from sdfkit_tpu_torch.utils.camera import camera_rays

            ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near,
                                 cfg.far)
            rays = [c.contiguous().view(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
            lib = rk.build.load_rays_bwd(prog)
            if k == 0:
                g, g_rays = torch.empty(params.numel(), dtype=torch.float64), torch.empty((6, npix))
                lib.raymarch_rays_bwd_replay_host(
                    params.data_ptr(), *torch_host._ray_args(rays, cfg, want_color),
                    cot.data_ptr(), g_rays.data_ptr(), g.data_ptr())
                g = g.float()
            else:
                g, g_rays = rk.launch_rays_bwd(lib, params, rays, cfg, want_color, cot)
            out.append(np.concatenate([g.numpy(), g_rays.numpy().reshape(-1)]))
        elif path == "store":
            _, store = rk.launch(rk.build.load(prog, store=True), params, v19, cfg, want_color,
                                 want_store=True)
            out.append(rk.launch_bwd(rk.build.load_bwd(prog, store=True), params, v19, cfg,
                                     want_color, cot, store=store).numpy())
        else:
            out.append(rk.launch_bwd(rk.build.load_bwd(prog), params, v19, cfg, want_color,
                                     cot).numpy())
    small, large = out
    assert np.abs(small).max() > 0
    np.testing.assert_allclose(large, small, rtol=1e-5, atol=1e-6)


def test_large_tier_source_keeps_no_array_of_slots():
    """The emitted large-tier adjoint declares no array, and the large
    tier's parts of the kernel sources none whose length is a number of
    parameter slots."""
    prog = sc.compile_scene(union_grid_scene(24))
    src = prog.adjoint_source
    assert prog.large and "#define SDF_LARGE 1" in src
    assert not re.search(r"\b(?:float|int|unsigned|bool)\s+\w+\s*\[", src), "an array"
    assert "sdf_dist_unit" not in src and "uP" not in src
    for name in ("sdf_dist_vjp", "sdf_dist_vjp_pair", "sdf_eval_vjp"):
        assert re.search(rf"SDF_SPARSE \w+ {name}\(", src)
    slot_lengths = ("kNOut", "kNAcc", "kSdfNSlots", "kSdfNOut", "SDF_N_PARAMS",
                    "SDF_N_DIST_SLOTS", "kNParams")
    for path in ("raymarch_bwd.cuh", "raymarch_bwd.cu", "raymarch_rays_bwd.cu"):
        text = (rk.build.CSRC / path).read_text()
        large = "".join(re.findall(r"#if SDF_LARGE\n(.*?)#endif  // SDF_LARGE", text, re.S)
                        + re.findall(r"#else\n// The large-scene tier(.*?)\n#endif", text, re.S))
        assert large, path
        for decl in re.findall(r"\b(?:float|int)\s+\w+\[([^\]]+)\]", large):
            assert not any(k in decl for k in slot_lengths), (path, decl)


class PaletteRadius(SdfExpr):
    """A sphere whose radius is row ``index`` of a palette: a palette read
    by the distance."""

    fields = ("table",)
    statics = ("index",)

    def eval(self, p: V3):
        r, _, _ = ops.take_rows(self.table, p.x * 0.0 + self.index)
        return V3(0.8, 0.5, 0.3), p.length() - r


@pytest.mark.parametrize("rows", [sc.PALETTE_UNROLLED_ROWS + 1, 400])
def test_palette_in_the_distance_takes_a_run_time_row(host_kernels, rows):
    """A distance that reads a palette of more than PALETTE_UNROLLED_ROWS
    rows takes the large tier, whose adjoint adds its cotangent to the row
    it read (``sdf_acc_at``): the source does not grow with the rows, and
    the gradient reaches that row alone, as autograd of the plain path's."""
    table = np.random.default_rng(rows).uniform(0.6, 1.0, (rows, 3)).astype(np.float32)
    expr = PaletteRadius(table, index=7.0)
    prog = sc.compile_scene(expr)
    assert prog.large and prog.n_params == 3 * rows
    assert "sdf_acc_at" in prog.adjoint_source
    short = sc.compile_scene(PaletteRadius(table[:sc.PALETTE_UNROLLED_ROWS + 1], index=7.0))
    assert len(prog.adjoint_source) - len(short.adjoint_source) < 64
    view = st.look_at(*VIEW)
    cfg = RenderConfig(16, 12)
    got = port_grads(expr, view, cfg, True, "kernel")
    assert host_kernels["bwd"] == 1
    g = got[0][0]
    assert np.abs(g[7, 0]) > 0 and np.count_nonzero(g[:, 0]) == 1
    assert_grads_close(got, port_grads(expr, view, cfg, True, "torch"))


def test_large_tier_costs_count_the_path():
    """``operation_counts`` of a large program counts what one evaluation's
    adjoint needs: the forward and the reverse sweep down one path of
    regions, a few dozen operations at 200 spheres where the straight-line
    adjoint had 5,000."""
    counts = sc.operation_counts(sc.compile_scene(union_grid_scene()))
    assert counts["dist"] == 2199
    assert counts["dist"] < counts["dist_unit"] < counts["dist"] + 1000
    assert counts["slots_added"] < 50
