"""Marching cubes on the port (``sdfkit_tpu_torch/mesh/marching_cubes.py``).

* The reference's golden vertex counts (``tests/test_marching_cubes.py``,
  ``tests/test_native.py``, ``tests/test_sample.py``) on the port's own
  ``voxelize``.
* Parity on one grid (the port's voxelization, and seeded random grids full of
  ambiguous cases) handed to the JAX package's ``create_mesh`` and to the
  port's: vertices and triangles identical, normals within 2e-5, colours
  within 2^-11 |c| + 1e-6 (the JAX package rounds colours to float16).
* The port's C++ sparse phase against its numpy oracle ``create_mesh_numpy``
  in both of the C++ dedup modes (vertices and triangles identical, normals
  within 2e-5, colours within 1e-6), and against the C++ sequential baseline.
* The native loader raises, and nothing falls back, when the compiler or a
  host/device consistency guard fails.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
from sdfkit_tpu.mesh import marching_cubes as jax_mc
from sdfkit_tpu_torch import native
from sdfkit_tpu_torch.mesh import marching_cubes as mc

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")


def voxels_of(expr, lo, hi, n, clip=True):
    lo3 = lo if isinstance(lo, tuple) else (lo,) * 3
    hi3 = hi if isinstance(hi, tuple) else (hi,) * 3
    with torch.no_grad():
        return st.voxelize(expr, lo3, hi3, n, n, n, clip_to_bounds=clip)


def mesh_of(expr, lo, hi, n, clip=True, **kw):
    return voxels_of(expr, lo, hi, n, clip).to_mesh(**kw)


def jax_voxels(v):
    return sk.Voxels(*(jnp.asarray(getattr(v, k).numpy()) for k in ("values", "colors",
                                                                    "vmin", "vmax")))


def oracle(v, **kw):
    return mc.create_mesh_numpy(v.values.numpy(), v.colors.numpy(), v.vmin, v.vmax, **kw)


def assert_same_mesh(m, ref, color_rtol=0.0, color_atol=1e-6):
    np.testing.assert_array_equal(m.vertices, ref.vertices)
    np.testing.assert_array_equal(m.triangles, ref.triangles)
    np.testing.assert_allclose(m.normals, ref.normals, atol=2e-5, rtol=0)
    np.testing.assert_allclose(m.colors, ref.colors, atol=color_atol, rtol=color_rtol)


def assert_matches_jax(m, jm):
    """The JAX package rounds colours to float16: 2^-11 relative."""
    assert_same_mesh(m, jm, color_rtol=2.0 ** -11)


# -- goldens (Tests/MarchingCubesTests.cs) ------------------------------------


class TestGoldenCounts:
    def test_sphere5(self):
        m = mesh_of(st.sphere(1.0), -1.5, 1.5, 5)
        assert len(m.vertices) == 54
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 1.0) < 0.3

    def test_sphere10(self):
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 10)
        assert len(m.vertices) == 312
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 2.0) < 0.2

    def test_box10(self):
        m = mesh_of(st.box(2.0), -2.5, 2.5, 10)
        assert len(m.vertices) == 384
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 2.0) < 0.3

    def test_unclipped_sphere_empty(self):
        m = mesh_of(st.sphere(2.0), -1.0, 1.0, 10, clip=False)
        assert len(m.vertices) == 0 and len(m.triangles) == 0

    def test_clipped_sphere(self):
        m = mesh_of(st.sphere(2.0), -1.0, 1.0, 10, clip=True)
        assert len(m.vertices) == 384
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] - 2.0) < 1e-1

    def test_cylinder50(self):
        v = voxels_of(st.cylinder(1.0, 3.0), (-1.5, -3.5, -1.5), (1.5, 3.5, 1.5), 50)
        m = v.to_mesh()
        assert len(m.vertices) == 7456
        assert np.abs(m.center).max() < 1e-6
        assert abs(m.size[0] / 2 - 1.0) < 1e-1

    def test_sphere128_progress(self):
        got = []
        v = voxels_of(st.sphere(3.0), -3.1, 3.1, 128)
        m = v.to_mesh(progress=got.append)
        assert len(m.vertices) == 72240
        assert all(0.0 <= f <= 1.0 for f in got)
        # Progress fires per z layer during the sweep (MarchingCubes.cs:81).
        assert got[0] == 0.0 and got[-1] == 1.0
        assert got == sorted(got)
        assert len(set(got)) > 100
        assert np.linalg.norm(m.center) < 1e-6
        assert abs(m.size[0] / 2 - 3.0) < 0.1

    def test_colored_spheres(self):
        s = st.union(
            st.sphere(0.4, color=(1.0, 0.2, 0.3)).translate(-1, 0, 0),
            st.sphere(0.2, color=(0.1, 1.0, 0.3)).translate(1, 0, 0),
        )
        m = mesh_of(s, -3.0, 3.0, 32)
        assert len(m.vertices) == len(m.colors) == 104
        assert m.colors[0][0] > 0.5

    def test_sphere32_1248(self):
        m = mesh_of(st.sphere(0.5), -1.0, 1.0, 32)
        assert len(m.vertices) == 1248

    def test_step2(self):
        # step=2 on a 20-grid visits x, y, z in {0, 2, ..., 16} (the
        # reference's `while (x < n-2*step) { x += step; }`).
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 20, step=2)
        assert len(m.vertices) == 312
        assert abs(m.size[0] / 2 - 2.0) < 0.3

    def test_step2_odd_extent(self):
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 21, step=2)
        assert len(m.vertices) == 342
        assert abs(m.size[0] / 2 - 2.0) < 0.3


class TestSdfTestsGoldens:
    """Tests/SdfTests.cs: the primitive and the compiled-expression tier agree."""

    def test_mesh_sphere_1248_primitive_tier(self):
        m = st.sphere(0.5).to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        assert len(m.vertices) == 1248

    def test_mesh_sphere_1248_solid_expr_tier(self):
        m = st.solid(lambda p: p.length() - 0.5).to_mesh((-1, -1, -1), (1, 1, 1), 32, 32, 32)
        assert len(m.vertices) == 1248


class TestMeshProperties:
    def test_normals_point_outward(self):
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 16)
        v = m.vertices / np.linalg.norm(m.vertices, axis=1, keepdims=True)
        assert (v * m.normals).sum(axis=1).mean() > 0.9

    def test_normals_unit_length(self):
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 10)
        np.testing.assert_allclose(np.linalg.norm(m.normals, axis=1), 1.0, atol=1e-5)

    def test_triangles_index_valid(self):
        m = mesh_of(st.sphere(2.0), -2.5, 2.5, 10)
        assert len(m.triangles) % 3 == 0
        assert m.triangles.min() >= 0 and m.triangles.max() < len(m.vertices)

    def test_iso_value_offset(self):
        # iso=0.5 on a sphere of r=1 extracts the r=1.5 shell (unclipped: the
        # wall value ~0.21 lies below the iso).
        m = mesh_of(st.sphere(1.0), -2.5, 2.5, 24, clip=False, iso_value=0.5)
        assert abs(np.median(np.linalg.norm(m.vertices, axis=1)) - 1.5) < 0.1

    def test_obj_export(self, tmp_path):
        m = mesh_of(st.sphere(1.0), -1.5, 1.5, 5)
        p = tmp_path / "sphere.obj"
        m.write_obj(p)
        text = p.read_text().splitlines()
        assert sum(1 for l in text if l.startswith("v ")) == 54
        assert sum(1 for l in text if l.startswith("vn ")) == 54
        assert sum(1 for l in text if l.startswith("f ")) == len(m.triangles) // 3
        assert text[-1].startswith("f ") and "//" in text[-1]

    def test_obj_matches_the_jax_package(self, tmp_path):
        v = voxels_of(st.sphere(1.0), -1.5, 1.5, 8)
        v.to_mesh().write_obj(tmp_path / "port.obj")
        jax_mc.create_mesh(jax_voxels(v)).write_obj(tmp_path / "jax.obj")
        assert (tmp_path / "port.obj").read_text() == (tmp_path / "jax.obj").read_text()

    def test_mesh_transform_roundtrip(self):
        m = mesh_of(st.sphere(1.0), -1.5, 1.5, 8)
        t = np.eye(4, dtype=np.float32)
        t[3, :3] = [1.0, 2.0, 3.0]
        m2 = m.transform(t)
        np.testing.assert_allclose(m2.center, m.center + [1, 2, 3], atol=1e-5)
        np.testing.assert_allclose(m2.normals, m.normals, atol=1e-5)

    def test_too_small_a_volume_is_an_empty_mesh(self):
        got = []
        v = voxels_of(st.sphere(1.0), -1.5, 1.5, 1)
        m = v.to_mesh(progress=got.append)
        assert len(m.vertices) == 0 and got == [0.0, 1.0]

    def test_timings_name_the_phases(self):
        mesh_of(st.sphere(0.5), -1.0, 1.0, 24)
        assert set(mc.LAST_TIMINGS) == {
            "dense_classify_ms", "fetch_ms", "native_index_ms", "native_geometry_ms",
            "color_ms", "grad_finalize_ms", "colors_wait_ms"}

    def test_to_mesh_leaves_no_autograd_tape(self):
        s = st.sphere(0.5)
        m = s.to_mesh((-1, -1, -1), (1, 1, 1), 12, 12, 12)
        assert len(m.vertices) > 0 and s.radius.grad is None


# -- parity with the JAX package and with the numpy oracle ------------------------


def csg_scene():
    return st.sphere(1.0, color=(1.0, 0.2, 0.1)) | st.box(
        (0.4, 0.9, 0.6), color=(0.1, 0.9, 0.2)).translate(0.5, 0.2, 0.0)


def torus_scene():
    return st.torus(0.9, 0.35) | st.sphere(0.5).translate(0.0, 0.0, 0.8)


def colored_spheres():
    return st.union(st.sphere(0.4, color=(1.0, 0.2, 0.3)).translate(-1, 0, 0),
                    st.sphere(0.2, color=(0.1, 1.0, 0.3)).translate(1, 0, 0))


SCENES = {
    "sphere5": (lambda: st.sphere(1.0), -1.5, 1.5, 5, {}),
    "csg33": (csg_scene, -1.5, 1.5, 33, {}),
    "torus50": (torus_scene, -1.5, 1.5, 50, {}),
    "colored32": (colored_spheres, -3.0, 3.0, 32, {}),
    "step2_odd21": (lambda: st.sphere(2.0), -2.5, 2.5, 21, {"step": 2}),
    "iso_offset24": (lambda: st.sphere(1.0, color=(0.3, 0.6, 0.9)), -2.5, 2.5, 24,
                     {"iso_value": 0.5}),
}


def random_voxels(seed, shape=(13, 11, 12)):
    """Uniform values in [-1, 1]: nearly every cell is active, and the
    ambiguous cases (3, 4, 6, 7, 10, 12, 13) and their internal tests all
    occur."""
    rng = np.random.default_rng(seed)
    values = rng.uniform(-1, 1, shape).astype(np.float32)
    colors = rng.uniform(0, 1, shape + (3,)).astype(np.float32)
    return st.Voxels(torch.from_numpy(values), torch.from_numpy(colors),
                     torch.tensor([-1.0, -2.0, -0.5]), torch.tensor([1.0, 1.5, 0.5]))


@pytest.mark.parametrize("name", SCENES)
def test_same_grid_as_the_jax_package(name):
    make, lo, hi, n, kw = SCENES[name]
    v = voxels_of(make(), lo, hi, n, clip=not kw.get("iso_value"))
    m = v.to_mesh(**kw)
    assert len(m.vertices) > 0
    assert_matches_jax(m, jax_mc.create_mesh(jax_voxels(v), **kw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_grid_as_the_jax_package(seed):
    v = random_voxels(seed)
    m = v.to_mesh()
    cases = mc.luts.cases[:, 0]
    # The grid reaches every MC33 case.
    bits = np.zeros((12, 10, 11), np.int64)
    vals = v.values.numpy()
    for k, (dx, dy, dz) in enumerate(mc._CORNERS):
        bits += (vals[dx:dx + 12, dy:dy + 10, dz:dz + 11] > 0).astype(np.int64) << k
    assert set(cases[bits.reshape(-1)]) >= set(range(1, 15))
    assert_matches_jax(m, jax_mc.create_mesh(jax_voxels(v)))


@pytest.mark.parametrize("workers", [1, 4], ids=["direct", "threaded"])
@pytest.mark.parametrize("name", ["csg33", "torus50", "colored32", "step2_odd21",
                                  "iso_offset24", "random"])
def test_cpp_sparse_phase_against_the_numpy_oracle(name, workers):
    if name == "random":
        v, kw = random_voxels(7, (17, 19, 15)), {}
    else:
        make, lo, hi, n, kw = SCENES[name]
        v = voxels_of(make(), lo, hi, n, clip=not kw.get("iso_value"))
    native.set_geo_workers(workers)
    try:
        m = v.to_mesh(**kw)
    finally:
        native.set_geo_workers(-1)
    assert_same_mesh(m, oracle(v, **kw))


def test_numpy_oracle_matches_the_jax_numpy_path(monkeypatch):
    """The port's oracle is the JAX package's numpy sparse phase, whole."""
    v = voxels_of(csg_scene(), -1.5, 1.5, 20)
    monkeypatch.setenv("SDFKIT_TPU_NO_NATIVE", "1")
    assert_matches_jax(oracle(v), jax_mc.create_mesh(jax_voxels(v)))


class TestSequentialBaseline:
    def test_counts_match_create_mesh(self):
        v = voxels_of(st.sphere(0.5), -1.0, 1.0, 32)
        m = v.to_mesh()
        n_verts, stream_len = native.mc_sequential_baseline(v.values.numpy(),
                                                            v.colors.numpy(), 1, 0.0)
        assert n_verts == len(m.vertices) == 1248
        assert stream_len == len(m.triangles)

    def test_counts_match_no_colors(self):
        v = voxels_of(st.torus(0.9, 0.35), -1.5, 1.5, 24)
        m = v.to_mesh()
        assert native.mc_sequential_baseline(v.values.numpy(), None, 1, 0.0) == (
            len(m.vertices), len(m.triangles))

    def test_counts_match_at_step2_and_an_iso(self):
        v = voxels_of(st.sphere(1.0), -2.5, 2.5, 25, clip=False)
        m = v.to_mesh(step=2, iso_value=0.5)
        assert native.mc_sequential_baseline(v.values.numpy(), v.colors.numpy(), 2, 0.5) == (
            len(m.vertices), len(m.triangles))


# -- no fallback -----------------------------------------------------------------


@pytest.fixture
def fresh_loader(monkeypatch, tmp_path):
    """The loader as at its first use, building into an empty directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    return tmp_path


def test_loader_raises_when_the_compiler_is_missing(monkeypatch, fresh_loader):
    monkeypatch.setattr(native, "CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        native.lib()
    v = voxels_of(st.sphere(0.5), -1.0, 1.0, 8)
    with pytest.raises(RuntimeError, match="no-such-compiler-xyz"):
        v.to_mesh()
    assert native._lib is None and "native_geometry_ms" not in mc.LAST_TIMINGS


def test_loader_raises_with_the_compilers_message(monkeypatch, fresh_loader):
    fake = fresh_loader / "fake-cxx"
    fake.write_text("#!/bin/sh\necho 'error: this compiler refuses' >&2\nexit 1\n")
    fake.chmod(0o755)
    monkeypatch.setattr(native, "CXX", str(fake))
    with pytest.raises(RuntimeError, match="this compiler refuses"):
        native.lib()
    assert not list((fresh_loader / "build").iterdir())  # no partial library left


def test_loader_builds_into_its_directory(fresh_loader):
    native.lib()
    (built,) = (fresh_loader / "build").iterdir()
    assert built.name.startswith("mc_host_") and built.suffix == ".so"


def test_a_point_count_disagreement_raises(monkeypatch):
    v = voxels_of(st.sphere(0.5), -1.0, 1.0, 12)
    monkeypatch.setattr(native.McSparse, "expected_points", lambda self: -1)
    with pytest.raises(RuntimeError, match="corner points"):
        v.to_mesh()


def test_the_cpp_guards_raise():
    active = np.array([0, 5], np.int64)
    with pytest.raises(RuntimeError, match="outside"):
        native.McSparse(np.array([0, 99], np.int64), 2, 2, 2, 3, 3, 3, 1, 0.0)
    with native.McSparse(active, 2, 2, 2, 3, 3, 3, 1, 0.0) as sparse:
        assert sparse.expected_points() == 14  # two cells sharing an edge
        with pytest.raises(RuntimeError, match="13 corner values"):
            sparse.geometry(np.zeros(13, np.float32))
