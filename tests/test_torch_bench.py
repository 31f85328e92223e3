"""The port's benchmark (``bench_torch.py``) on the CPU: it imports no JAX,
refuses to run without a card, and its render, roofline, drift and grad
sections run at 40x24 on CPU tensors with ``tests/torch_host.py``'s g++
loops in place of the launches, returning ``bench.py``'s keys; the frame they
measure against the JAX package's render of ``bench.sphere_repeat_scene()``;
the one count of the kernels' work (``render/cuda/work.py``) at 1920x1080x40;
the statistics and the headline's shape.

The card's run of every section is ``chip_smoke.py`` phase 22.
"""

import copy
import json
import pathlib
import shutil
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import bench_torch
import sdfkit_tpu as sk
import sdfkit_tpu_torch as st
import torch_parity as tp
from bench import sphere_repeat_scene as jax_sphere_repeat
from sdfkit_tpu_torch import scenes
from sdfkit_tpu_torch.render import raymarch
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.render.cuda import work
from sdfkit_tpu_torch.sdf.compile import compile_scene
from torch_host import host_libraries, patch_kernels

torch.set_num_threads(1)
# The port's default device is the card; these tests ask for the CPU.
st.set_default_device("cpu")

REPO = pathlib.Path(__file__).resolve().parents[1]
W, H = 40, 24
# SphereRepeat at 1920x1080x40 from bench.py's view: the pixels the kernels'
# depth render hits (bench_torch.py's roofline and chip_smoke.py's "work:"
# line, on an NVIDIA H100 80GB HBM3).
HITS_1080P = 2_016_531


def host_clock(fn, warmup=bench_torch.WARMUP, reps=bench_torch.REPS):
    """The CPU's stand-in for the bench's two clocks: the same calls, timed
    on the host."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler (g++) to build the kernel bodies")
    return host_libraries(tmp_path_factory.mktemp("bench_host"))


@pytest.fixture
def on_host(host_libs, monkeypatch):
    """The bench's sections on CPU tensors: the g++ loops in place of the
    launches (counted as the launches count themselves), the scene taken for
    a card's so that ``backend="auto"`` takes the kernels, and the host
    clock in place of the card's."""
    patch_kernels(monkeypatch, host_libs)
    for name, counter in (("launch", "LAUNCHES"), ("launch_bwd", "BWD_LAUNCHES")):
        def counted(*a, _fn=getattr(rk, name), _counter=counter, **k):
            setattr(rk, _counter, getattr(rk, _counter) + 1)
            return _fn(*a, **k)

        monkeypatch.setattr(rk, name, counted)
    monkeypatch.setattr(raymarch, "_on_cuda", lambda expr: True)
    monkeypatch.setattr(bench_torch, "sync", lambda: None)
    monkeypatch.setattr(bench_torch, "host_ms", host_clock)
    monkeypatch.setattr(bench_torch, "device_ms", host_clock)


@pytest.fixture
def render(on_host):
    return bench_torch.bench_render(W, H)


# -- no JAX, no CPU run ---------------------------------------------------------

NO_JAX = textwrap.dedent("""
    import sys
    sys.modules["jax"] = None          # any `import jax` now raises ImportError
    sys.path.insert(0, {repo!r})
    import bench_torch
    bad = [m for m, mod in sys.modules.items() if mod is not None
           and (m in ("sdfkit_tpu", "bench") or m.startswith(("sdfkit_tpu.", "jax")))]
    assert not bad, bad
    print("ok")
""")


def test_bench_imports_neither_jax_nor_the_jax_package():
    proc = subprocess.run([sys.executable, "-c", NO_JAX.format(repo=str(REPO))],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("ok")


def test_without_a_card_the_bench_exits_non_zero_and_names_cuda(tmp_path):
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], capture_output=True,
                          text=True, timeout=120, cwd=tmp_path)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr
    assert proc.stdout == ""
    assert list(tmp_path.iterdir()) == []


def test_without_a_card_no_section_runs(monkeypatch, capsys):
    ran = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in dir(bench_torch):
        if name.startswith("bench_"):
            monkeypatch.setattr(bench_torch, name, lambda *a, _n=name, **k: ran.append(_n))
    assert bench_torch.main([]) == 1
    assert ran == []
    assert capsys.readouterr().out == ""


# -- the sections at 40x24 on the host -----------------------------------------------

# bench.py's keys of each section, with the port's names where the JAX
# package's name a TPU backend ("fused", "jnp": "kernel", "plain") or a unit
# the port does not count in (FLOPs of XLA's cost analysis: operations).
RENDER_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
RENDER_EXTRA_KEYS = {"render_ms", "backend", "render_ms_kernel", "render_ms_plain", "build_s"}
ROOFLINE_KEYS = {"frame_gops", "hbm_floor_mb", "lightspeed_ms_compute", "lightspeed_ms_memory",
                 "bound", "census_ops_per_ray", "census_bwd_ops_per_ray", "lightspeed_ms_grad"}
GRAD_KEYS = {"grad_Mrays_per_s", "grad_ms", "grad_backend", "grad_ms_kernel", "grad_ms_plain",
             "grad_parity_ok", "grad_parity_max_rel_err_8iter", "grad_parity_max_rel_err_40iter",
             "grad_parity_noise_floor_40iter", "grad_parity_40iter_ok"}
DRIFT_KEYS = {"max", "median", "px_gt_1e-3", "px_gt_1e-2", "px_gt_5e-2", "px_total"}


def assert_checks_pass(out):
    assert out["checks"] and all(out["checks"].values()), out["checks"]


def test_render_section(render):
    assert RENDER_KEYS <= set(render)
    assert RENDER_EXTRA_KEYS <= set(render["extra"])
    assert render["metric"] == f"sphere_repeat_render_{W}x{H}" and render["unit"] == "Mrays/s"
    extra = render["extra"]
    assert extra["backend"] == "kernel"
    assert extra["launches_per_timed_frame"] == [1.0, 0.0]
    for key, n in (("render_ms_kernel", 2 * bench_torch.REPS),
                   ("render_ms_plain", 2 * bench_torch.REPS), ("launch_ms", bench_torch.REPS)):
        assert extra[key]["n"] == n
        assert 0 < extra[key]["median"] <= extra[key]["p90"]
    assert render["value"] == pytest.approx(W * H / extra["render_ms"] / 1e3)
    assert render["vs_baseline"] == pytest.approx(
        extra["render_ms_plain"]["median"] / extra["render_ms"])
    assert_checks_pass(render)
    json.dumps(render)


def test_roofline_section(render):
    out = bench_torch.bench_roofline(render, W, H)
    assert ROOFLINE_KEYS <= set(out)
    assert_checks_pass(out)
    program = compile_scene(scenes.sphere_repeat_scene())
    costs = work.frame_work(program, 40, W * H, out["hits"], out["march_steps"])
    assert out["lightspeed_ms"] == costs["fwd"].bound()[0]
    assert out["lightspeed_ms_fixed"] == costs["fwd_fixed"].bound()[0]
    assert out["bwd_lightspeed_ms"] == costs["bwd"].bound()[0]
    assert out["lightspeed_ms"] < out["lightspeed_ms_fixed"]
    assert out["frame_gops_fixed"] * 1e9 == W * H * work.fixed_operations_per_pixel(program, 40)
    json.dumps(out)


def test_drift_section(on_host):
    out = bench_torch.bench_fused_drift(((W, H), (17, 13)))
    assert set(out["fused_drift"]) == {f"fused_drift_{W}x{H}", "fused_drift_17x13"}
    for entry in out["fused_drift"].values():
        assert DRIFT_KEYS <= set(entry)
    assert out["fused_drift"][f"fused_drift_{W}x{H}"]["px_total"] == W * H
    assert_checks_pass(out)


def test_grad_section(on_host):
    out = bench_torch.bench_grad(W, H)
    assert GRAD_KEYS <= set(out)
    assert out["grad_backend"] == "kernel" and out["grad_plain_shape"] == [W, H]
    assert out["launches_per_timed_step"] == [1.0, 1.0]
    assert out["grad_ms_kernel"]["n"] == out["grad_ms_plain"]["n"] == 2 * bench_torch.REPS
    assert_checks_pass(out)
    json.dumps(out)


def test_headline_keeps_bench_pys_shape_under_2000_characters(render):
    # Every key the headline takes, each at its longest form.
    found = {k: 123456.789012 for k in bench_torch.HEADLINE_KEYS}
    found.update(render["extra"], backend="kernel", grad_plain_shape=[1920, 1080])
    tag = {"device": "NVIDIA H100 80GB HBM3", "power_limit_w": 700.0}
    line = bench_torch.headline(render, found, True, tag)
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "extra"}
    for key in ("render_ms", "backend", "grad_ms", "grad_parity_ok", "render_3840x2160_ms",
                "voxel_Msamples_per_s", "mesh_256^3_ms", "mesh_512^3_vertices", "icp_10000_ms",
                "icp_100000_max_err", "scaling_efficiency_n2_pct", "scaling_efficiency_n4_pct",
                "scaling_efficiency_n8_pct", "correct", "device", "power_limit_w"):
        assert key in line["extra"], key
    assert line["extra"]["render_ms_plain"] == float(
        f"{render['extra']['render_ms_plain']['median']:.6g}")
    assert len(json.dumps(line)) < 2000


# -- the scaling section: one card under gloo, and the cards under NCCL -----------------

@pytest.fixture(scope="module")
def cpu_audit(tmp_path_factory):
    """``tools/torch_scaling.py``'s JSON from 1 and 2 ``gloo`` ranks on the
    CPU, the plain render at the sections' 40x24."""
    proc = subprocess.run(
        [sys.executable, str(REPO / "tools" / "torch_scaling.py"), "--device", "cpu", "--backend",
         "torch", "--devices", "1", "2", "--width", str(W), "--height", str(H), "--timeout",
         "120"], capture_output=True, text=True, timeout=180,
        cwd=tmp_path_factory.mktemp("audit"))
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def stand_in_audit(cpu_audit, calls):
    """``bench_torch.scaling_audit`` on the CPU: the tool's run above, with
    what the card's run would show where the CPU's cannot: one image-forward
    launch per rank and frame (the plain path launches none), and under
    NCCL a card of its own for each rank."""
    def audit(group, devices, width, height, iters):
        calls.append((group, tuple(devices), width, height, iters))
        out = copy.deepcopy(cpu_audit)
        out["process_group"] = group
        out["points"] = [p for p in out["points"] if p["devices"] in devices]
        for p in out["points"]:
            p["launches_per_frame"] = [1.0] * p["devices"]
            p["shared_device"] = group == "gloo" and p["devices"] > 1
        if group == "nccl":
            out["rank_devices"] = [f"0000:{0x18 + 0x10 * r:02x}:00" for r in range(2)]
        return out

    return audit


@pytest.mark.parametrize("cards", [1, 4])
def test_scaling_section_over_the_cards(on_host, cpu_audit, monkeypatch, cards):
    """One card: the 4K bands' stand-ins and the gloo audit, as before. More
    cards: also the audit over the cards under NCCL, its walltime
    efficiency per point and each band's ms, and its checks."""
    calls = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(bench_torch, "AUDIT_RANKS", (1, 2))
    out = bench_torch.bench_scaling(W, H, audit=stand_in_audit(cpu_audit, calls))
    assert_checks_pass(out)
    assert [p["devices"] for p in out["real_chip_shard_scaling"]] == list(
        bench_torch.SCALING_COUNTS)
    groups = ["gloo", "nccl"] if cards > 1 else ["gloo"]
    assert calls == [(g, (1, 2), W, H, 40) for g in groups]
    assert out["torch_scaling_audit"]["process_group"] == "gloo"
    assert out["spmd_work_partition_n2_pct"] == 100.0
    if cards == 1:
        assert "torch_scaling_cards" not in out and "cards_walltime_efficiency_n2_pct" not in out
        return
    audit = out["torch_scaling_cards"]
    assert audit["process_group"] == "nccl" and len(set(audit["rank_devices"])) == 2
    for p, ran in zip(audit["points"], cpu_audit["points"]):
        assert p["walltime_efficiency_pct"] == ran["walltime_efficiency_pct"]
        assert p["band_ms"] == ran["band_ms"] and len(p["band_ms"]) == p["devices"]
        assert p["shared_device"] is False
    assert out["cards_walltime_efficiency_n2_pct"] == audit["points"][1]["walltime_efficiency_pct"]
    line = bench_torch.headline({}, out, True, {})
    assert line["extra"]["cards_walltime_efficiency_n2_pct"] == float(
        f"{out['cards_walltime_efficiency_n2_pct']:.6g}")
    json.dumps(out)


def test_a_cards_audit_that_shares_a_card_fails_its_check(on_host, cpu_audit, monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(bench_torch, "AUDIT_RANKS", (1, 2))
    calls = []
    shared = stand_in_audit(cpu_audit, calls)

    def audit(group, *args):
        out = shared(group, *args)
        out["rank_devices"] = ["0000:18:00"] * 2
        return out

    checks = bench_torch.bench_scaling(W, H, audit=audit)["checks"]
    assert checks.pop("scaling: the cards audit put each rank on a card of its own") is False
    assert all(checks.values())


# -- the slice against the JAX package --------------------------------------------------

def test_the_bench_frame_matches_the_jax_packages_render(on_host):
    """The frame the render section measures (the kernels' g++ loops here)
    against the JAX package's render of bench.py's scene from its view."""
    with torch.no_grad():
        m = bench_torch.bench_marcher(W, H)
        rgb, depth = m.render().numpy(), m.render_depth().numpy()
    assert m.backend == "kernel"
    jview = sk.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    jm = sk.RayMarcher(W, H, jax_sphere_repeat(), view=jview)
    tp.assert_depth_close(depth, np.asarray(jm.render_depth()))
    tp.assert_rgb_close_but_far(rgb, np.asarray(jm.render()), depth)


# -- the one count of the kernels' work -----------------------------------------------------

def test_the_work_of_sphere_repeat_at_1080p():
    """The figures of chip_smoke.py's "work:" lines and PERF.md: 6.534e9
    fixed operations, a 0.0975 ms fixed-work bound for the image forward,
    0.4177 ms for the image backward and 0.3368 ms for the store-fed one."""
    program = compile_scene(scenes.sphere_repeat_scene())
    npix = 1920 * 1080
    costs = work.frame_work(program, 40, npix, HITS_1080P, npix * 39)
    assert costs["fwd_fixed"].operations == 6_533_913_600
    assert costs["fwd_fixed"].operations == npix * work.fixed_operations_per_pixel(program, 40)
    assert costs["fwd_fixed"].bytes == npix * 12 + 4 * (program.n_params + 19)
    for key, ms, by in (("fwd_fixed", 0.0975, "operations"), ("bwd", 0.4177, "operations"),
                        ("bwd_store", 0.3368, "operations"), ("fwd_store", 0.1065, "bytes")):
        bound, what = costs[key].bound()
        assert (round(bound, 4), what) == (ms, by), key
    assert costs["fwd"].operations < costs["fwd_fixed"].operations
    assert "rays_fwd" not in costs


def test_march_steps_needed():
    settled = torch.tensor([0, 5, 38, 39])
    assert work.march_steps_needed(settled, 40) == 1 + 6 + 39 + 39


# -- statistics ---------------------------------------------------------------------------

def test_stats_of_a_fixed_list():
    assert bench_torch.stats([7.0, 1.0, 3.0, 10.0, 2.0, 9.0, 4.0, 8.0, 6.0, 5.0]) == {
        "median": 5.5, "p90": 9.1, "n": 10}
    assert bench_torch.stats([2.0]) == {"median": 2.0, "p90": 2.0, "n": 1}


def test_in_turns_runs_plain_kernel_kernel_plain():
    calls = []
    plain, kernel = bench_torch.in_turns(lambda: "p", lambda: "k",
                                         lambda fn: [calls.append(fn()) or len(calls)])
    assert calls == ["p", "k", "k", "p"]
    assert plain == [1, 4] and kernel == [2, 3]
