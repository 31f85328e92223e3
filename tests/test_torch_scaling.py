"""The port's scaling harness (``tools/torch_scaling.py``) on the CPU: 2
``gloo`` ranks spawned by the tool itself, the plain render at 32x24x40.

The card's run (CUDA events, the kernels, 4 ranks at 1920x1080) is
``chip_smoke.py`` phase 21; here the tool's plumbing: the JSON keeps the JAX
tool's keys, the static work halves at 2 ranks, the frame at 2 ranks is the
frame of one, and the tool writes no file unless asked.
"""

import hashlib
import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
TOOL = REPO / "tools" / "torch_scaling.py"
W, H, ITERS = 32, 24, 40
# tools/scaling.py's keys, its two renamed: per_device_flops is
# per_device_operations (nodes of the program, not instructions) and
# cores_exceeded is shared_device.
JAX_KEYS = {"workload", "backend", "render_backend", "host_cores", "num_processes", "points"}
JAX_POINT_KEYS = {"devices", "seconds", "mrays_per_s", "per_device_bytes",
                  "walltime_efficiency_pct", "work_partition_efficiency_pct"}
NEW_POINT_KEYS = {"per_device_operations", "shared_device", "band_ms", "band_efficiency_pct",
                  "launches_per_frame", "frame_equal_to_one_rank", "frame_sha256"}


def sha(path: pathlib.Path) -> str:
    return hashlib.sha256(path.read_bytes()).hexdigest()


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the tool's JSON, files left in its working directory, SCALING.json's
    hash before and after)."""
    cwd = tmp_path_factory.mktemp("scaling_cwd")
    before = sha(REPO / "SCALING.json")
    proc = subprocess.run(
        [sys.executable, str(TOOL), "--device", "cpu", "--backend", "torch", "--devices", "1",
         "2", "--width", str(W), "--height", str(H), "--iters", str(ITERS), "--timeout", "120"],
        capture_output=True, text=True, timeout=180, cwd=cwd)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    return out, sorted(p.name for p in cwd.iterdir()), before, sha(REPO / "SCALING.json")


def test_the_json_keeps_the_jax_tools_keys(run):
    out = run[0]
    assert JAX_KEYS <= set(out)
    assert out["workload"]["width"] == W and out["workload"]["height"] == H
    assert out["workload"]["depth_iterations"] == ITERS
    assert (out["backend"], out["render_backend"], out["num_processes"]) == ("cpu", "torch", 2)
    assert out["process_group"] == "gloo" and out["nvcc_builds"] == [0, 0]
    assert [p["devices"] for p in out["points"]] == [1, 2]
    for p in out["points"]:
        assert JAX_POINT_KEYS | NEW_POINT_KEYS <= set(p)
        assert p["seconds"] > 0 and p["mrays_per_s"] > 0
        assert len(p["band_ms"]) == p["devices"] and min(p["band_ms"]) > 0
        # The plain path launches no kernel.
        assert p["launches_per_frame"] == [0.0] * p["devices"]
        assert p["shared_device"] is False


def test_the_work_per_rank_halves(run):
    one, two = run[0]["points"]
    assert two["per_device_operations"] * 2 == one["per_device_operations"]
    assert one["per_device_operations"] == W * H * run[0]["per_pixel_operations"]
    assert two["work_partition_efficiency_pct"] == pytest.approx(100.0, rel=1e-12)
    assert one["walltime_efficiency_pct"] == pytest.approx(100.0, rel=1e-12)
    assert one["band_efficiency_pct"] == pytest.approx(100.0, rel=1e-12)


def test_the_frame_of_two_ranks_is_the_frame_of_one(run):
    one, two = run[0]["points"]
    assert one["frame_equal_to_one_rank"] and two["frame_equal_to_one_rank"]
    assert one["frame_sha256"] == two["frame_sha256"]


def test_no_file_is_written_without_out(run):
    _, left, before, after = run
    assert left == []
    assert before == after


def test_ranks_that_join_a_group_report_from_rank_0(tmp_path):
    """--init-method / --world-size / --rank: each process is one rank of the
    group; rank 0 prints the JSON and writes --out, the others neither."""
    procs = [subprocess.Popen(
        [sys.executable, str(TOOL), "--device", "cpu", "--backend", "torch", "--devices", "1",
         "2", "--width", "16", "--height", "8", "--init-method", f"file://{tmp_path}/rendezvous",
         "--world-size", "2", "--rank", str(r), "--timeout", "120", "--out",
         str(tmp_path / f"rank{r}.json")], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=tmp_path) for r in range(2)]
    outs = [p.communicate(timeout=180) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [err[-2000:] for _, err in outs]
    printed = json.loads(outs[0][0].strip().splitlines()[-1])
    assert printed == json.loads((tmp_path / "rank0.json").read_text())
    assert printed["num_processes"] == 2 and [p["devices"] for p in printed["points"]] == [1, 2]
    assert all(p["frame_equal_to_one_rank"] for p in printed["points"])
    assert outs[1][0].strip() == "" and not (tmp_path / "rank1.json").exists()
