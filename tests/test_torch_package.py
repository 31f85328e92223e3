"""The port as a package: no JAX, no nvcc at import, the default device, and
the backend choice on a machine without CUDA."""

import dataclasses
import os
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time
import types

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.raymarch import RenderConfig
from sdfkit_tpu_torch.sdf.compile import compile_scene

# The tensors here are small: torch's intra-op thread pool costs more than it
# saves, and on a loaded CPU its hand-offs made single ops take ~15 ms.
torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

NO_JAX = textwrap.dedent("""
    import subprocess, sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    def refuse(*a, **k):
        raise AssertionError(f"a process was started while importing: {a!r}")
    subprocess.run = subprocess.Popen = refuse
    import torch
    import sdfkit_tpu_torch as st
    st.set_default_device("cpu")
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build, raymarch_kernel
    from sdfkit_tpu_torch.io import png
    import importlib, pkgutil, tempfile
    names = [m.name for m in pkgutil.walk_packages(st.__path__, "sdfkit_tpu_torch.")]
    for required in ("parallel.elastic", "parallel.distributed", "parallel.train",
                     "parallel.marching", "grid", "mesh.voxels", "mesh.mesh", "sdf.sample",
                     "io.tga", "render.cuda.raymarch_kernel", "mesh.marching_cubes",
                     "mesh.luts", "native", "registration.icp"):
        assert "sdfkit_tpu_torch." + required in names, (required, names)
    for name in names:
        importlib.import_module(name)
    with torch.no_grad():
        img = st.render(scenes.sphere_repeat_scene(), 16, 8, camera_position=(-2, 2, 4))
        depth = st.render_depth(st.sphere(1.0), 16, 8)
        points = st.sample(st.sphere(1.0), [[0.0, 0.0, 0.0], [2.0, 0.0, 0.0]])
        volume = st.voxelize(st.sphere(1.0), (-1, -1, -1), (1, 1, 1), 3, 3, 3)
        with tempfile.TemporaryDirectory() as d:
            tiles, stats = st.parallel.render_tiles_resumable(st.sphere(1.0), 16, 8, d, tile_rows=4)
    assert img.shape == (8, 16, 3) and bool(torch.isfinite(img).all())
    assert depth.shape == (8, 16)
    assert points[:, 3].tolist() == [-1.0, 1.0] and volume.values.shape == (3, 3, 3)
    assert tiles.shape == (8, 16, 3) and stats["rendered"] == 2
    assert build.BUILDS == 0
    assert [getattr(raymarch_kernel, n) for n in dir(raymarch_kernel) if n.endswith("LAUNCHES")] == [0] * 6
    assert not any(m == "sdfkit_tpu" or m.startswith("sdfkit_tpu.") for m in sys.modules)
    print("ok")
""")


def test_imports_and_renders_without_jax_or_nvcc():
    proc = subprocess.run([sys.executable, "-c", NO_JAX], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_auto_picks_the_plain_path_on_the_cpu():
    m = st.RayMarcher(8, 4, st.sphere(1.0))
    assert m.backend == "torch" and m.device.type == "cpu"


def test_kernel_backend_raises_on_the_cpu():
    with pytest.raises(ValueError, match="CUDA"):
        st.RayMarcher(8, 4, st.sphere(1.0), backend="kernel")
    with pytest.raises(ValueError, match="unknown backend"):
        st.RayMarcher(8, 4, st.sphere(1.0), backend="fused")


def test_kernel_wrapper_rejects_cpu_tensors_without_building():
    builds, launches = build.BUILDS, rk.LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        rk.render_image_kernel(st.sphere(1.0), st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                               RenderConfig(8, 4))
    assert (build.BUILDS, rk.LAUNCHES) == (builds, launches)


def test_kernel_backward_is_not_a_silent_fallback():
    """A cotangent on the CPU raises: the backward builds nothing, launches
    nothing and does not go through the plain path instead."""
    ctx = types.SimpleNamespace(saved_tensors=(torch.zeros(5), torch.zeros(19)), program=None,
                                cfg=RenderConfig(8, 4), want_color=True)
    builds, launches = build.BUILDS, rk.BWD_LAUNCHES
    with pytest.raises(ValueError, match="CUDA"):
        rk._RenderImage.backward(ctx, torch.zeros(4, 8, 3))
    with pytest.raises(ValueError, match="CUDA"):
        rk.launch_bwd(None, torch.zeros(5), torch.zeros(19), RenderConfig(8, 4), True,
                      torch.zeros(32, 3))
    assert (build.BUILDS, rk.BWD_LAUNCHES) == (builds, launches)


# The constant bank holds 16,384 floats: the parameter slots and the 19 view
# scalars of a library fit there up to 16,365 slots.
CONSTANT_BANK_SLOTS = 64 * 1024 // 4 - 19


def _uniform_space(unit: str, tmp_path) -> str:
    """Where the generated translation unit ``unit`` keeps its uniforms:
    the qualifier of ``c_uniform`` once g++ has preprocessed it (a stand-in
    ``cuda_runtime.h``; nothing is compiled)."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to preprocess the generated unit")
    (tmp_path / "stub").mkdir(exist_ok=True)
    (tmp_path / "stub" / "cuda_runtime.h").write_text("")
    src = tmp_path / "unit.cu"
    src.write_text(unit)
    proc = subprocess.run(["g++", "-E", "-P", "-x", "c++", "-I", str(build.CSRC),
                           "-I", str(tmp_path / "stub"), str(src)],
                          capture_output=True, text=True, timeout=60, check=True)
    (line,) = [ln for ln in proc.stdout.splitlines() if "float c_uniform[" in ln]
    return line.split()[0]


def test_a_scene_too_large_for_constant_memory_raises_before_any_build(monkeypatch, tmp_path):
    """The kernels read the parameters and the 19 view scalars from one
    array: in the 64 KB constant bank where they fit, in device memory where
    they do not (``csrc/raymarch_uniforms.cuh``). No family refuses a scene
    for its size: a program one slot past the bank goes to the compiler as
    one that fits does (here the compiler raises before any build), and the
    generated unit keeps its uniforms in device memory."""
    program = compile_scene(st.sphere(1.0))
    fits = dataclasses.replace(program, n_params=CONSTANT_BANK_SLOTS, hash="fits")
    large = dataclasses.replace(program, n_params=CONSTANT_BANK_SLOTS + 1, hash="large")
    builds = build.BUILDS
    units = []

    def no_compiler(stem, unit):
        units.append(unit)
        raise RuntimeError("no nvcc in this test")

    monkeypatch.setattr(build, "_compile", no_compiler)
    for prog in (fits, large):
        for family in build.FAMILIES:
            with pytest.raises(RuntimeError, match="no nvcc in this test"):
                build.load_family(prog, family)
    assert build.BUILDS == builds and len(units) == 2 * len(build.FAMILIES)
    spaces = {(prog.hash, family): _uniform_space(build.translation_unit(prog, family), tmp_path)
              for prog in (fits, large) for family in ("fwd", "rays_fwd")}
    assert spaces == {("fits", "fwd"): "__constant__", ("fits", "rays_fwd"): "__constant__",
                      ("large", "fwd"): "__device__", ("large", "rays_fwd"): "__device__"}


def _render_through_raymarcher(sdf, backend, tmp_path):
    return st.RayMarcher(8, 4, sdf, backend=backend).render()


def _render_through_render(sdf, backend, tmp_path):
    return st.render(sdf, 8, 4, camera_position=(0.0, 0.0, 5.0), backend=backend)


def _render_through_fit(sdf, backend, tmp_path):
    return torch.tensor(st.fit(sdf, torch.full((4, 8, 3), 0.5), steps=1, backend=backend).losses)


def _render_through_tiles(sdf, backend, tmp_path):
    image, stats = st.parallel.render_tiles_resumable(sdf, 8, 4, tmp_path / "tiles", tile_rows=2,
                                                      backend=backend)
    assert stats["rendered"] == 2
    return torch.from_numpy(image)


def palette_scene(rows: int):
    """Spheres in cells coloured from a palette of ``rows`` seeded rows: a
    scene of ``3 * rows + 6`` parameter slots whose program stays small."""
    table = np.random.default_rng(5).uniform(0.2, 1.0, (rows, 3)).astype(np.float32)
    return st.sphere(0.4).repeat_indexed("xy", (1.125, 1.125), table,
                                         index_fn=lambda x, y, z: x * 37.0 + y)


@pytest.mark.parametrize("entry", [_render_through_raymarcher, _render_through_render,
                                   _render_through_fit, _render_through_tiles],
                         ids=["RayMarcher", "render", "fit", "render_tiles_resumable"])
def test_a_scene_too_large_for_constant_memory_takes_the_kernels(monkeypatch, tmp_path, entry):
    """A scene on CUDA whose parameter slots and view scalars do not fit in
    the constant bank takes the kernels under 'auto' and 'kernel' through
    every entry point, as any scene on CUDA does: it reaches the build of
    its first kernel (the compiler raises here), whose unit keeps the
    uniforms in device memory. The device check says CUDA; nothing runs on
    the plain path and nothing launches."""
    from sdfkit_tpu_torch.parallel import elastic, train
    from sdfkit_tpu_torch.render import raymarch

    fit_module = sys.modules["sdfkit_tpu_torch.fit"]  # the package exports the function

    sdf = palette_scene(5500)
    program = compile_scene(sdf)
    assert program.n_params == 16506 > CONSTANT_BANK_SLOTS
    resolved, units = [], []

    def spy(backend, expr):
        resolved.append(resolve(backend, expr))
        return resolved[-1]

    def no_compiler(stem, unit):
        units.append(unit)
        raise RuntimeError("no nvcc in this test")

    def no_plain_path(*args, **kwargs):
        raise AssertionError("the plain path rendered a scene on CUDA")

    resolve = raymarch.resolve_backend
    monkeypatch.setattr(raymarch, "_on_cuda", lambda expr: True)
    for module in (raymarch, fit_module, elastic):
        monkeypatch.setattr(module, "resolve_backend", spy)
    for module in (raymarch, train):  # the tiles' rows render through train.row_renderer
        monkeypatch.setattr(module, "render_rays", no_plain_path)
    # The scene's tensors are on the CPU: let the wrappers hand them on.
    monkeypatch.setattr(rk, "_check", lambda *a, **k: None)
    monkeypatch.setattr(rk, "_check_cuda_float32", lambda *a, **k: None)
    monkeypatch.setattr(build, "_compile", no_compiler)
    builds, launches = build.BUILDS, rk.LAUNCHES

    for backend in ("auto", "kernel"):
        with pytest.raises(RuntimeError, match="no nvcc in this test"):
            entry(sdf, backend, tmp_path / backend)
        assert resolved and set(resolved) == {"kernel"}, (backend, resolved)
    assert len(units) == 2 and f"#define SDF_N_PARAMS {program.n_params}" in units[0]
    assert _uniform_space(units[0], tmp_path) == "__device__"
    assert (build.BUILDS, rk.LAUNCHES) == (builds, launches)


class _Stream:
    """A stream as ``KernelLib.order_uniforms`` uses one, on card ``device_index``."""

    def __init__(self, log, name, device_index=0):
        self.log, self.name, self.device_index = log, name, device_index

    def record_event(self):
        self.log.append(("record", self.name))
        return "event of " + self.name

    def wait_event(self, event):
        self.log.append((self.name, "waits for", event))


def test_a_launch_on_another_stream_waits_for_the_last_one():
    """A library's uniforms are one buffer in constant memory that every
    launch overwrites on its stream. A launch on the stream of the last one is
    ordered by the stream; on another stream it first waits for an event
    recorded on the last one; each library keeps its own last stream."""
    log = []
    one, two = _Stream(log, "one"), _Stream(log, "two")
    lib = build.KernelLib(None, None, None, {}, {})
    other = build.KernelLib(None, None, None, {}, {})
    lib.order_uniforms(one)
    lib.order_uniforms(one)
    other.order_uniforms(two)
    assert log == [] and lib.last_streams == {0: one} and other.last_streams == {0: two}
    lib.order_uniforms(two)
    assert log == [("record", "one"), ("two", "waits for", "event of one")]
    lib.order_uniforms(two)
    other.order_uniforms(two)
    assert len(log) == 2
    lib.order_uniforms(one)
    assert log[2:] == [("record", "two"), ("one", "waits for", "event of two")]


def test_launches_on_two_cards_wait_for_nothing():
    """Each card holds its own copy of a library's uniforms: a launch waits
    only for the library's last launch on its own card."""
    log = []
    zero, one, other_zero = _Stream(log, "zero"), _Stream(log, "one", 1), _Stream(log, "zero'")
    lib = build.KernelLib(None, None, None, {}, {})
    lib.order_uniforms(zero)
    lib.order_uniforms(one)
    lib.order_uniforms(zero)
    assert log == [] and lib.last_streams == {0: zero, 1: one}
    lib.order_uniforms(other_zero)
    assert log == [("record", "zero"), ("zero'", "waits for", "event of zero")]


def test_the_ordered_launch_passes_the_stream_last_and_raises_on_an_error(monkeypatch):
    stream = types.SimpleNamespace(cuda_stream=77, device_index=0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: stream)
    seen = []
    lib = build.KernelLib(lambda *a: seen.append(a) or 0, None, None, {}, {})
    rk._run(lib, "raymarch_fwd", 1, 2.5)
    assert seen == [(1, 2.5, 77)] and lib.last_streams == {0: stream} and not lib.lock.locked()
    failing = build.KernelLib(lambda *a: 9, None, None, {}, {})
    with pytest.raises(RuntimeError, match="raymarch_bwd launch failed with CUDA error 9"):
        rk._run(failing, "raymarch_bwd")
    assert not failing.lock.locked()


def test_view_on_another_device_or_shape_raises():
    with pytest.raises(ValueError, match="4, 4"):
        st.RayMarcher(8, 4, st.sphere(1.0), view=torch.eye(3))
    meta = torch.eye(4, device="meta")
    with pytest.raises(ValueError, match="device|is on"):
        st.RayMarcher(8, 4, st.sphere(1.0), view=meta)


# -- the default device ---------------------------------------------------------

def test_building_a_scene_with_no_card_and_no_request_raises():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    with st.use_device(None):
        for make in (lambda: st.sphere(1.0), lambda: st.box(0.5).translate(1.0, 0.0, 0.0),
                     lambda: st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)),
                     lambda: st.torus(1.0, 0.3), lambda: st.default_device()):
            with pytest.raises(RuntimeError, match=r"set_default_device\('cpu'\)"):
                make()
    assert st.sphere(1.0).radius.device.type == "cpu"  # the module's request is back


NO_REQUEST = textwrap.dedent("""
    import torch
    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import scenes
    assert not torch.cuda.is_available()
    for make in (scenes.sphere_repeat_scene, lambda: st.render(st.sphere(1.0), 8, 4)):
        try:
            make()
        except RuntimeError as e:
            assert "device='cpu'" in str(e), e
        else:
            raise AssertionError("a scene was built on the CPU without being asked")
    img = st.render(st.sphere(1.0, device="cpu"), 8, 4)
    assert img.device.type == "cpu" and img.shape == (4, 8, 3)
    # sample, voxelize and the tile renderer follow the scene's device; what
    # has no scene to follow (bare cell centres, a loaded volume) follows the
    # package's default device, and so raises here.
    import tempfile
    import numpy as np
    from sdfkit_tpu_torch.grid import cell_centers
    ball = st.sphere(1.0, device="cpu")
    with torch.no_grad():
        assert st.sample(ball, np.zeros((3, 3), np.float32)).device.type == "cpu"
        vol = st.voxelize(ball, (-1, -1, -1), (1, 1, 1), 2, 2, 2)
        assert {t.device.type for t in (vol.values, vol.colors, vol.vmin, vol.vmax)} == {"cpu"}
        with tempfile.TemporaryDirectory() as d:
            tiles, _ = st.parallel.render_tiles_resumable(ball, 8, 4, d)
            assert tiles.shape == (4, 8, 3)
            vol.save(d + "/v.npz")
            for make in (lambda: cell_centers((0, 0, 0), (1, 1, 1), 2, 2, 2),
                         lambda: st.Voxels.load(d + "/v.npz")):
                try:
                    make()
                except RuntimeError as e:
                    assert "device='cpu'" in str(e), e
                else:
                    raise AssertionError("a tensor was made on the CPU without being asked")
            assert st.Voxels.load(d + "/v.npz", device="cpu").values.device.type == "cpu"
    print("ok")
""")


def test_a_fresh_process_never_picks_the_cpu_silently():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device: the default is the card")
    proc = subprocess.run([sys.executable, "-c", NO_REQUEST], capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_the_three_ways_to_ask_for_the_cpu():
    with st.use_device(None):
        with st.use_device("cpu"):
            assert st.sphere(1.0).radius.device.type == "cpu"
        s = st.sphere(1.0, color=(0.2, 0.3, 0.4), device="cpu")
        assert {p.device.type for p in st.leaves(s)} == {"cpu"}
        assert st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0), device="cpu").device.type == "cpu"
        # A modifier or a combinator follows the scene it wraps.
        moved = (s.translate(1.0, 0.0, 0.0).scale(2.0) | s.round(0.1)).repeat_xy(3.0, 3.0)
        assert {p.device.type for p in st.leaves(moved)} == {"cpu"}
        assert st.render_depth(moved, 8, 4).device.type == "cpu"
    st.set_default_device("cpu")
    assert st.default_device() == torch.device("cpu")


def test_factories_follow_the_requested_device():
    with st.use_device("meta"):
        scene = scenes_on_default()
        assert {p.device.type for p in st.leaves(scene)} == {"meta"}
        assert st.sdf.scene_device(scene).type == "meta"
        assert st.look_at((0, 0, 5), (0, 0, 0), (0, 1, 0)).device.type == "meta"
    assert st.sdf.scene_device(scenes_on_default()).type == "cpu"
    assert st.box(0.5, device="meta").translate(1, 0, 0).offset.device.type == "meta"


def scenes_on_default():
    from sdfkit_tpu_torch import scenes

    return scenes.sphere_repeat_scene() | st.torus(1.0, 0.2) | st.capsule((0, 0, 0), (1, 0, 0), 0.1)


def test_default_device_is_the_card_when_there_is_one():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    with st.use_device(None):
        scene = st.sphere(1.0)
        assert scene.radius.device.type == "cuda"
        assert st.RayMarcher(8, 4, scene).backend == "kernel"


def test_sample_voxelize_and_the_containers_are_exported():
    from sdfkit_tpu_torch.grid import voxelize
    from sdfkit_tpu_torch.mesh import Mesh, Voxels
    from sdfkit_tpu_torch.sdf.sample import sample

    assert (st.sample, st.voxelize, st.Voxels, st.Mesh) == (sample, voxelize, Voxels, Mesh)
    assert {"sample", "voxelize", "Voxels", "Mesh"} <= set(st.__all__)


def test_fit_is_exported():
    from sdfkit_tpu_torch.fit import FitResult, fit

    assert st.fit is fit and st.FitResult is FitResult and "fit" in st.__all__


def test_meshing_and_registration_are_exported():
    from sdfkit_tpu_torch.mesh.marching_cubes import create_mesh
    from sdfkit_tpu_torch.registration import icp

    assert st.create_mesh is create_mesh
    names = ("IterativeClosestPoint", "register_points_torch", "global_register_points",
             "NearestNeighbors", "GridNN", "nearest_neighbors")
    assert all(getattr(st, n) is getattr(icp, n) for n in names)
    assert {"create_mesh", *names} <= set(st.__all__)


FAKE_NVCC = """\
import os, sys, time
args = sys.argv[1:]
out, src = args[args.index("-o") + 1], args[-1]
with open(out, "w") as f:
    f.write("a library half written")
time.sleep(1.0)  # both processes have written their source by now
with open(src) as f:
    seen = f.read()
with open(os.environ["FAKE_NVCC_UNIT"]) as f:
    if seen != f.read():
        sys.exit("the source is not the unit this process wrote")
with open(out, "w") as f:
    f.write(seen)
"""

COMPILE = """\
import os, pathlib, sys, time
from sdfkit_tpu_torch.render.cuda import build
build.BUILD_DIR = pathlib.Path(sys.argv[1])
build.nvcc_path = lambda: sys.argv[2]
unit = pathlib.Path(os.environ["FAKE_NVCC_UNIT"]).read_text()
while not pathlib.Path(sys.argv[3]).exists():
    time.sleep(0.005)
so, seconds, log = build._compile("raymarch_fwd_race", unit)
print(so, seconds is not None)
"""


def test_two_processes_building_one_stem_each_compile_their_own_source(tmp_path, monkeypatch):
    """Two ranks that build the same scene structure at once: each nvcc
    reads the source its own process wrote (the fake compiler fails on any
    other), and the library left in place is whole. A build that fails
    leaves no file of its own behind."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(f"#!{sys.executable}\n" + FAKE_NVCC)
    nvcc.chmod(0o755)
    build_dir, go = tmp_path / "_build", tmp_path / "go"
    procs = []
    for who in ("a", "b"):
        unit = tmp_path / f"unit_{who}.cu"
        unit.write_text(f"// the unit of process {who}\n")
        env = dict(os.environ, FAKE_NVCC_UNIT=str(unit))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", COMPILE, str(build_dir), str(nvcc), str(go)],
            env=env, cwd=str(pathlib.Path(st.__file__).parents[1]),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    time.sleep(3.0)  # both have imported the package and wait for the go
    go.touch()
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err for _, err in outs]
    built = [line.split() for line, _ in outs]
    assert all(b[1] == "True" for b in built), built  # both ran the compiler
    library = (build_dir / "raymarch_fwd_race.so").read_text()
    assert library in ("// the unit of process a\n", "// the unit of process b\n")
    assert (build_dir / "raymarch_fwd_race.cu").read_text() in (
        "// the unit of process a\n", "// the unit of process b\n")
    assert sorted(p.name for p in build_dir.iterdir()) == ["raymarch_fwd_race.cu",
                                                           "raymarch_fwd_race.so"]

    # Another stem whose compiler fails after writing part of its output.
    monkeypatch.setattr(build, "BUILD_DIR", build_dir)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setenv("FAKE_NVCC_UNIT", str(tmp_path / "unit_a.cu"))
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build._compile("raymarch_fwd_broken", "// not the unit the compiler expects\n")
    assert sorted(p.name for p in build_dir.iterdir()) == ["raymarch_fwd_race.cu",
                                                           "raymarch_fwd_race.so"]


@pytest.mark.parametrize("table", ["mesh/_luts_data.py", "native/_mc_luts.h"])
def test_copied_tables_equal_the_jax_packages(table):
    """The port keeps byte-identical copies of the marching-cubes tables that
    tools/gen_luts.py and tools/gen_luts_header.py generate for the JAX
    package; both files are read as data."""
    repo = pathlib.Path(__file__).resolve().parents[1]
    ours = (repo / "sdfkit_tpu_torch" / table).read_bytes()
    assert ours and ours == (repo / "sdfkit_tpu" / table).read_bytes()
