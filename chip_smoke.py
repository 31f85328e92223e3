#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the hand-written forward kernel from the sources in this checkout,
holds it against the plain PyTorch path and the committed goldens, checks
that a parameter edit rebuilds nothing, then renders the SphereRepeat scene
at 1920x1080 with 40 iterations through ``RayMarcher(backend="auto")`` and
times the kernel and the plain path with CUDA events. It imports nothing of
JAX. It exits non-zero, with no result line, when there is no CUDA device or
any check fails; on success the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import pathlib
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
ARTIFACTS = ROOT / "artifacts"
WIDTH, HEIGHT = 1920, 1080
WARMUP, TIMED = 3, 10
KERNEL_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_fwd.cu"
REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:354"

FAILURES: list[str] = []


def check(ok: bool, what: str) -> None:
    print(("PASS " if ok else "FAIL ") + what, flush=True)
    if not ok:
        FAILURES.append(what)


def sh(cmd: list[str]) -> str:
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unavailable ({e})"
    return (proc.stdout + proc.stderr).strip()


def distributional(a: np.ndarray, b: np.ndarray) -> tuple[bool, dict]:
    """The contract of tests/test_goldens.py:66-68 for RGB from two programs:
    median |diff| <= 5e-3, at most 0.5% of pixels off by more than 1e-2 and
    at most 0.1% by more than 5e-2."""
    d = np.abs(a - b)
    px = d.max(axis=-1)
    n = px.size
    stats = {
        "max": float(d.max()),
        "median": float(np.median(d)),
        "px_gt_1e-2": int((px > 1e-2).sum()),
        "px_gt_5e-2": int((px > 5e-2).sum()),
        "pixels": int(n),
    }
    ok = (stats["median"] <= 5e-3 and stats["px_gt_1e-2"] <= 0.005 * n
          and stats["px_gt_5e-2"] <= 0.001 * n)
    return ok, stats


def depth_close(a: np.ndarray, b: np.ndarray) -> tuple[bool, dict]:
    """Depth from two programs (the kernel contracts FMAs, the plain path
    does not): relative error at most 1e-3 everywhere and a median of at
    most 1e-5. Miss rays reach ~1e12, so the error is relative; the 40 steps
    compound ulp differences on silhouette-grazing rays (same bound as
    tests/test_torch_raymarch.py)."""
    err = np.abs(a - b) / np.maximum(np.abs(b), 1.0)
    stats = {"max_rel": float(err.max()), "median_rel": float(np.median(err)),
             "px_gt_1e-4": int((err > 1e-4).sum()), "pixels": int(err.size)}
    return stats["max_rel"] <= 1e-3 and stats["median_rel"] <= 1e-5, stats


def rgb_close(a: np.ndarray, b: np.ndarray) -> tuple[bool, dict]:
    """RGB from two programs on a small frame: max |diff| below 2e-2 and
    median at most 1e-4 (the finite-difference normal turns a 1-ulp distance
    difference into ~1e-2 relative noise on a hit pixel's shading)."""
    d = np.abs(a - b)
    stats = {"max": float(d.max()), "median": float(np.median(d)), "pixels": int(d.size // 3)}
    return stats["max"] < 2e-2 and stats["median"] <= 1e-4, stats


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    if not GOLDENS.is_dir():
        print(f"chip_smoke: {GOLDENS} is missing; run from a checkout of the repository",
              file=sys.stderr)
        return 1

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.io.png import read_png, write_png
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
    from sdfkit_tpu_torch.sdf.compile import compile_scene

    dev = torch.device("cuda", 0)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc = [ln for ln in sh([build.nvcc_path(), "--version"]).splitlines() if "release" in ln]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"gpu: {smi}")
    print(f"nvcc: {nvcc[0] if nvcc else 'unknown'}")
    torch.backends.cuda.matmul.allow_tf32 = False

    def scene(expr):
        return expr.to(dev)

    def view(eye=(0.0, 0.0, 5.0)):
        return st.look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device=dev)

    def both(expr, w, h, v, depth=False):
        """(kernel, plain) frames of one scene on the card."""
        with torch.no_grad():
            k = st.RayMarcher(w, h, expr, view=v, backend="kernel")
            p = st.RayMarcher(w, h, expr, view=v, backend="torch")
            out = (k.render_depth(), p.render_depth()) if depth else (k.render(), p.render())
        torch.cuda.synchronize()
        return tuple(o.cpu().numpy() for o in out)

    # -- 1. build the SphereRepeat program ---------------------------------
    # Libraries left by an earlier run would be loaded instead of built:
    # start from the sources alone.
    shutil.rmtree(build.BUILD_DIR, ignore_errors=True)
    hero = scene(scenes.sphere_repeat_scene())
    prog = compile_scene(hero)
    t0 = time.perf_counter()
    lib = build.load(prog)
    load_s = time.perf_counter() - t0
    print(f"build: program {prog.hash}, {prog.n_params} parameter slots, "
          f"{len(prog.eval_live)} nodes; nvcc {lib.build_seconds} s (load {load_s:.3f} s); "
          f"registers per thread {lib.registers}")
    check(lib.build_seconds is not None, "the kernel was built from the checkout's sources")
    torch.cuda.synchronize()

    # -- 2. kernel against the plain path and the goldens --------------------
    for name, expr in (("sphere", st.sphere(1.0)), ("box", st.box(1.0)),
                       ("plane", st.plane_xy())):
        k, p = both(scene(expr), 50, 30, view(), depth=True)
        golden = np.load(GOLDENS / f"{name}_depth_50x30.npy")
        check(np.allclose(k, golden, rtol=1e-4, atol=1e-4),
              f"{name} depth 50x30 kernel vs golden rtol 1e-4 "
              f"(max rel {float(np.max(np.abs(k - golden) / np.abs(golden))):.3g})")
        ok, stats = depth_close(k, p)
        check(ok, f"{name} depth 50x30 kernel vs plain {stats}")

    palette = [[0.9, 0.2, 0.2], [0.2, 0.9, 0.2], [0.2, 0.2, 0.9]]
    small = {
        "repeat_xy": lambda: st.sphere(1.0, color=(0.9, 0.4, 0.2)).repeat_xy(2.5, 2.5),
        "cell_colors": lambda: st.sphere(0.5).repeat_xy(
            1.125, 1.125,
            lambda i, p, c, d: st.V3(0.9 - st.ops.abs(i.x) / 6.0, 0.9 - st.ops.abs(i.y) / 6.0,
                                     st.ops.full_like(i.z, 0.9))),
        "palette": lambda: st.sphere(0.5).repeat_indexed("xy", (1.125, 1.125), palette),
    }
    for name, make in small.items():
        expr = scene(make())
        for w, h in ((40, 24), (17, 13)):
            k, p = both(expr, w, h, view(), depth=True)
            ok, stats = depth_close(k, p)
            check(ok, f"{name} depth {w}x{h} kernel vs plain {stats}")
            k, p = both(expr, w, h, view())
            ok, stats = rgb_close(k, p)
            check(ok, f"{name} rgb {w}x{h} kernel vs plain {stats}")

    golden = read_png(GOLDENS / "sphere_repeat_192x108.png")
    k, p = both(hero, 192, 108, view((-2.0, 2.0, 4.0)))
    ok, stats = distributional(np.clip(k, 0.0, 1.0), golden)
    check(ok, f"SphereRepeat 192x108 kernel vs golden PNG {stats}")
    ok, stats = distributional(k, p)
    check(ok, f"SphereRepeat 192x108 kernel vs plain {stats}")

    # -- 3. a parameter edit rebuilds nothing (checked at full size, where
    #       the distributional contract counts enough pixels) ---------------
    builds = build.BUILDS
    radius = hero.a.child.radius
    with torch.no_grad():
        before = st.RayMarcher(WIDTH, HEIGHT, hero, view=view((-2.0, 2.0, 4.0)),
                               backend="kernel").render().cpu().numpy()
        radius.fill_(0.45)
    k2, p2 = both(hero, WIDTH, HEIGHT, view((-2.0, 2.0, 4.0)))
    check(build.BUILDS == builds, f"radius edit: builds {builds} -> {build.BUILDS}")
    check(float(np.abs(k2 - before).max()) > 1e-2, "radius edit changed the frame")
    ok, stats = distributional(k2, p2)
    check(ok, f"radius edit: kernel vs plain at {WIDTH}x{HEIGHT} {stats}")
    with torch.no_grad():
        radius.fill_(0.5)
    torch.cuda.synchronize()

    # -- 4. the slice at full size: SphereRepeat 1920x1080x40 ----------------
    marcher = st.RayMarcher(WIDTH, HEIGHT, hero, view=view((-2.0, 2.0, 4.0)))
    check(marcher.backend == "kernel", f"backend='auto' on CUDA picked {marcher.backend!r}")
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    frame = marcher.render()
    torch.cuda.synchronize()
    launches = rk.LAUNCHES
    check(launches > 0, f"the 1920x1080 frame went through the kernel (LAUNCHES={launches})")
    frame = frame.detach().cpu().numpy()
    check(frame.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(frame).all()),
          f"frame {frame.shape} is finite")
    plain = st.RayMarcher(WIDTH, HEIGHT, hero, view=view((-2.0, 2.0, 4.0)), backend="torch")
    with torch.no_grad():
        plain_frame = plain.render().cpu().numpy()
    torch.cuda.synchronize()
    ok, full_stats = distributional(frame, plain_frame)
    check(ok, f"1920x1080 kernel vs plain {full_stats}")
    ARTIFACTS.mkdir(exist_ok=True)
    write_png(ARTIFACTS / "sphere_repeat_1920x1080.png", frame)

    # -- 5. time both paths with CUDA events (plain, kernel, kernel, plain) -
    def time_frames(m) -> float:
        with torch.no_grad():
            for _ in range(WARMUP):
                m.render()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TIMED):
                m.render()
            stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / TIMED

    rounds = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        rounds[which].append(time_frames(plain if which == "plain" else marcher))
    kernel_ms = float(np.mean(rounds["kernel"]))
    plain_ms = float(np.mean(rounds["plain"]))
    # The launch alone, without the per-frame host work of the wrapper
    # (structure lookup, parameter concatenation, 4x4 inverses).
    with torch.no_grad():
        params = st.sdf.leaves(hero)
        params = torch.cat([q.reshape(-1) for q in params]).contiguous()
        v19 = rk.view19(marcher.view, marcher.config)
        for _ in range(WARMUP):
            rk.launch(lib, params, v19, marcher.config, True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(TIMED):
            rk.launch(lib, params, v19, marcher.config, True)
        stop.record()
    torch.cuda.synchronize()
    launch_ms = start.elapsed_time(stop) / TIMED
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing kernel launch alone: {launch_ms:.4f} ms/frame on {smi}")
    for which, ms in (("kernel", kernel_ms), ("plain", plain_ms)):
        print(f"timing {which}: SphereRepeat {WIDTH}x{HEIGHT}x40 {ms:.4f} ms/frame "
              f"(rounds {rounds[which]}), {WIDTH * HEIGHT / ms / 1e3:.2f} Mrays/s "
              f"on {smi}")
    torch.cuda.synchronize()

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"kernels": [{
        "name": "raymarch_fwd", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": full_stats["max"], "ms": kernel_ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
