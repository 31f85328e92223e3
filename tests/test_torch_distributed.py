"""The sharded paths over 2 and 4 ``gloo`` ranks on the CPU.

``tools/torch_distributed_demo.py`` spawns the ranks (one process each, a
``file://`` rendezvous in a temporary directory) and each rank runs the
checks of ``__graft_entry__.dryrun_multichip`` against a mesh of one rank:
frames, voxel bricks and meshes bit for bit, the train step within the
dryrun's rtol 5e-5 / atol 5e-5, ``fit(mesh=)`` within rtol 1e-3, tiles over
the mesh and resumed on one rank. The ranks run the plain route and, as
``tests/torch_distributed_worker.py`` with the g++ build of the kernels'
per-pixel code in place of the launches, the kernel route: its padded last
band and its backward once per band. Here their outputs are held to the JAX package's
sharded functions on a 4-device virtual CPU mesh, with the tolerances of
``test_torch_parallel.py``, and to each other. Skipped where subprocesses
are unavailable (as ``tests/test_distributed.py``).
"""

import copy
import json
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import sdfkit_tpu_torch as st
import torch_parity as tp
from sdfkit_tpu_torch.sdf.compile import compile_scene
from test_torch_parallel import (
    FIT,
    LR,
    VOX,
    assert_mesh_matches_jax,
    assert_two_program_grads,
    fit_target,
    hero,
    jax_refs,
    mesh_scene,
    palette,
)
from torch_host import host_libraries

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))
import chip_smoke  # noqa: E402
import torch_distributed_demo as demo  # noqa: E402


def _can_spawn() -> bool:
    try:
        return subprocess.run([sys.executable, "-c", "print('ok')"], capture_output=True,
                              timeout=60).returncode == 0
    except (OSError, subprocess.SubprocessError):
        return False


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """The g++ libraries of the scenes the ranks render through the kernel
    route, built once here (the ranks load them); None without g++."""
    if shutil.which("g++") is None:
        return None
    build_dir = tmp_path_factory.mktemp("host_kernels")
    get = host_libraries(build_dir)
    for expr in (hero(st), palette(st), st.sphere(0.7, color=(0.4, 0.4, 0.4))):
        get(compile_scene(expr))
    return build_dir


@pytest.fixture(scope="module", params=[2, 4], ids=["2_ranks", "4_ranks"])
def run(request, tmp_path_factory, host_build):
    """(ranks, reports, outputs per rank, whether the kernel route ran)."""
    if not _can_spawn():
        pytest.skip("subprocesses unavailable")
    n = request.param
    out = tmp_path_factory.mktemp(f"ranks_{n}")
    host = {} if host_build is None else dict(
        worker=REPO / "tests" / "torch_distributed_worker.py",
        worker_args=["--host-kernels", str(host_build)])
    reports = demo.launch(n, device="cpu", out=out, timeout=280.0, **host)
    outputs = [dict(np.load(out / f"rank{r}.npz")) for r in range(n)]
    return n, reports, outputs, host_build is not None


def routes(run):
    return ["", "k_"] if run[3] else [""]


def test_every_rank_passed_every_check(run):
    n, reports, _, kernels = run
    assert [r["rank"] for r in reports] == list(range(n))
    assert {(r["ranks"], r["backend"], r["device"]) for r in reports} == {(n, "gloo", "cpu")}
    failed = [what for r in reports for ok, what in r["checks"] if not ok]
    assert failed == []
    # Rank 0 also resumes the tiles alone, once per route.
    counts = [len(r["checks"]) for r in reports]
    assert counts[0] == counts[1] + len(routes(run)) and len(set(counts[1:])) == 1
    assert counts[0] >= (28 if kernels else 18)


def test_every_rank_returns_the_same_results(run):
    _, _, outputs, _ = run
    for other in outputs[1:]:
        assert other.keys() == outputs[0].keys()
        for key in outputs[0]:
            np.testing.assert_array_equal(other[key], outputs[0][key], err_msg=key)


def test_frames_match_the_jax_mesh(run):
    ref = jax_refs()
    out = run[2][0]
    with torch.no_grad():
        marcher = st.RayMarcher(16, 9, hero(st))
        np.testing.assert_array_equal(out["render_rgb"], marcher.render().numpy())
        np.testing.assert_array_equal(out["render_depth"], marcher.render_depth().numpy())
    for route in routes(run):
        tp.assert_rgb_close(out[f"{route}render_rgb"], ref["render_rgb"])
        tp.assert_depth_close(out[f"{route}render_depth"], ref["render_depth"])


@pytest.mark.parametrize("name", ["train", "pal"])
def test_train_steps_match_the_jax_mesh(run, name):
    ref = jax_refs()
    out = run[2][0]
    start = hero(st) if name == "train" else palette(st)
    sizes = [p.numel() for p in st.leaves(start)]
    for route in routes(run):
        flat = out[f"{route}{name}_leaves"]
        new = np.split(flat, np.cumsum(sizes)[:-1])
        grads = [(a.detach().numpy().reshape(-1) - b) / LR for a, b in zip(st.leaves(start), new)]
        np.testing.assert_allclose(float(out[f"{route}{name}_loss"]), ref[f"{name}_loss"],
                                   rtol=1e-3)
        assert_two_program_grads(grads, [g.reshape(-1) for g in ref[f"{name}_grads"]])


def test_voxel_bricks_are_voxelize_and_match_the_jax_mesh(run):
    ref = jax_refs()
    got = run[2][0]["vox_values"]
    with torch.no_grad():
        whole = st.voxelize(hero(st), (-1, -1, -1), (1, 1, 1), *VOX)
    np.testing.assert_array_equal(got, whole.values.numpy())
    np.testing.assert_allclose(got, ref["vox_values"], atol=2e-7)


def test_the_mesh_is_to_mesh_and_matches_the_jax_mesh(run):
    ref = jax_refs()
    out = run[2][0]
    want = st.voxelize(mesh_scene(st), (-1, -1, -1), (1, 1, 1), 16, 16, 16).to_mesh()
    for f in ("vertices", "triangles", "normals", "colors"):
        np.testing.assert_array_equal(out[f"mesh_{f}"], getattr(want, f), err_msg=f)
    assert_mesh_matches_jax(out["mesh_vertices"], out["mesh_triangles"], out["mesh_normals"],
                            out["mesh_colors"], ref["mesh"])
    assert {r["mesh_vertices"] for r in run[1]} == {len(want.vertices)}


def test_fit_matches_the_jax_mesh_fit(run):
    ref = jax_refs()
    out = run[2][0]
    for route in routes(run):
        np.testing.assert_array_equal(out[f"{route}fit_target"], fit_target())
        assert out[f"{route}fit_losses"].shape == (FIT["steps"],)
        np.testing.assert_allclose(out[f"{route}fit_losses"], ref["fit_losses"], rtol=1e-3,
                                   atol=1e-5)


def test_the_kernel_route_launches_once_per_band(run):
    """Every rank launches the image forward once per call and, in a
    gradient step, the image backward once for its band."""
    if not run[3]:
        pytest.skip("no host C++ compiler (g++) for the kernel route")
    for r in run[1]:
        launches = r["launches"]
        assert launches["k_render_sharded_16x9"] == [1, 0]
        assert launches["k_train_step_sharded"] == [1, 1]
        assert launches["k_fit_mesh"] == [FIT["steps"], FIT["steps"]]
        assert launches["k_tiles"] == [3, 0]
        assert all(v == [0, 0] for k, v in launches.items() if not k.startswith("k_"))


# -- chip_smoke.py phase 23's line, from these ranks as stand-ins for a card each ---------

def as_cards(reports):
    """The reports as ranks on a card each in an NCCL group would give them:
    the same checks, launches and times, the backend and the cards relabelled."""
    out = copy.deepcopy(reports)
    for r in out:
        r.update(backend="nccl", device=f"cuda:{r['rank']}",
                 pci_bus_id=f"0000:{0x18 + 0x10 * r['rank']:02x}:00")
    return out


def one_process_stand_in(n):
    order = [0, n - 1, 0, 1, *range(2, n - 1)]
    return {"order": order, "first": 0, "cards": [
        {"card": d, "outputs_on": [f"cuda:{d}"] * 3, "current_device": 0, "launches": [3, 1],
         "rgb_equal": True, "depth_equal": True, "loss_equal": True, "grads_equal": True,
         "rgb_mean": 0.5, "loss": 0.01} for d in order]}


def test_the_sharded_cards_line_parses(run):
    n, reports, _, kernels = run
    if not kernels:
        pytest.skip("no host C++ compiler (g++) for the kernel route")
    cards = as_cards(reports)
    vertices = {demo.SIZES["small"]["grid"]: reports[0]["mesh_vertices"]}
    one = one_process_stand_in(n)
    checks = chip_smoke.cards_checks(cards, "small", vertices, n, one=one)
    assert checks and all(ok for ok, _ in checks), [w for ok, w in checks if not ok]
    line = json.loads(json.dumps({"sharded_cards": chip_smoke.cards_line(
        cards, "small", {}, one, "NVIDIA H100 80GB HBM3, 700.00 W", n, 1.0)}))["sharded_cards"]
    assert line["ran"] and (line["cards"], line["ranks"], line["backend"]) == (n, n, "nccl")
    assert [d["device"] for d in line["devices"]] == [f"cuda:{r}" for r in range(n)]
    assert line["mesh_vertices"] == {"16": reports[0]["mesh_vertices"]}
    forward = chip_smoke.cards_launches(line, 0)
    assert {k: v for k, v in forward.items() if k.startswith("k_")} == {
        "k_render_sharded_16x9": n, f"k_render_sharded_16x{2 * n + 1}": n,
        "k_train_step_sharded": n, "k_fit_mesh": n * FIT["steps"], "k_tiles": 3 * n}
    # The plain route, which the ranks here run too, launches nothing.
    assert all(v == 0 for k, v in forward.items() if not k.startswith("k_"))
    assert chip_smoke.cards_launches(line, 1)["k_train_step_sharded"] == n
    assert chip_smoke.cards_launches({"ran": False, "cards": 1}, 0) == {}


def failing_checks(reports, n, vertices, one=None):
    return [w for ok, w in chip_smoke.cards_checks(reports, "small", vertices, n, one=one)
            if not ok]


def test_the_sharded_cards_checks_fail_where_a_card_run_would(run):
    n, reports, _, kernels = run
    if not kernels:
        pytest.skip("no host C++ compiler (g++) for the kernel route")
    vertices = {demo.SIZES["small"]["grid"]: reports[0]["mesh_vertices"]}
    shared = as_cards(reports)
    shared[1]["pci_bus_id"] = shared[0]["pci_bus_id"]
    assert len(failing_checks(shared, n, vertices)) == 1
    gloo = as_cards(reports)
    gloo[0]["backend"] = "gloo"
    assert len(failing_checks(gloo, n, vertices)) == 1
    twice = as_cards(reports)
    twice[-1]["launches"]["k_render_sharded_16x9"] = [2, 0]
    assert len(failing_checks(twice, n, vertices)) == 1
    built = as_cards(reports)
    built[0]["nvcc_builds"] = 1
    assert len(failing_checks(built, n, vertices)) == 1
    assert len(failing_checks(as_cards(reports), n, {16: 1})) == 1
    other = one_process_stand_in(n)
    other["cards"][1]["rgb_equal"] = False
    assert len(failing_checks(as_cards(reports), n, vertices, other)) == 1
