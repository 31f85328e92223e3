#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout and drives
both paths of the port at full size, SphereRepeat at 1920x1080 with 40
iterations:

1-5  the forward: the kernel against the plain PyTorch path and the
     committed goldens, a parameter edit that rebuilds nothing, a frame
     through ``RayMarcher(backend="auto")``, and its time;
6    the backward kernel against autograd of the plain path on the card,
     every leaf and the view, RGB and depth, on small scenes;
7    two backward launches at full size: bit-identical, finite gradients;
8    ``fit`` for 5 steps at full size through the two kernels, and the
     gradient against the plain path's at the largest frame whose autograd
     tape fits;
9    times with CUDA events, and a profile of the fit steps.

Scenes are built with no device argument: the package's default device is
the card. The script imports nothing of JAX. It exits non-zero, with no
result line, when there is no CUDA device or any check fails; on success the
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``,
after one line of JSON that lists the kernels.
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
FIT_STEPS = 5
START_RADIUS = 0.55  # the fit's start; the target frame has 0.5
KERNEL_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_fwd.cu"
REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:354"
BWD_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_bwd.cu"
BWD_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:479"
# Published peaks of one H100 SXM: float32 outside the tensor cores, HBM3.
PEAK_FP32_OPS = 67e12
PEAK_BYTES = 3.35e12

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

    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    nvcc = [ln for ln in sh([build.nvcc_path(), "--version"]).splitlines() if "release" in ln]
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    print(f"gpu: {smi}")
    print(f"nvcc: {nvcc[0] if nvcc else 'unknown'}")
    torch.backends.cuda.matmul.allow_tf32 = False

    def view(eye=(0.0, 0.0, 5.0)):
        return st.look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))

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
    hero = scenes.sphere_repeat_scene()
    check(st.sdf.scene_device(hero).type == "cuda" and view().device.type == "cuda",
          f"a scene and a view built with no device argument are on "
          f"{st.sdf.scene_device(hero)} and {view().device}")
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
        k, p = both(expr, 50, 30, view(), depth=True)
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
        expr = make()
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

    # -- 6. the backward kernel against autograd of the plain path, on the card
    def grads(expr, w, h, v, backend, depth, target=None, iters=40):
        """(flat leaf gradients, view gradient, loss) of one scene on the
        card: sum(img**2), sum(where(d<50,d,0)**2), or the fit's mean squared
        error when a target is given."""
        for q in st.leaves(expr):
            q.grad = None
        v = v.clone().requires_grad_()
        m = st.RayMarcher(w, h, expr, view=v, backend=backend, depth_iterations=iters)
        if depth:
            d = m.render_depth()
            loss = (torch.where(d < 50.0, d, torch.zeros_like(d)) ** 2).sum()
        elif target is not None:
            loss = torch.mean((m.render() - target) ** 2)
        else:
            loss = (m.render() ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad).reshape(-1)
                          for q in st.leaves(expr)])
        return flat.cpu().numpy(), v.grad.cpu().numpy(), loss.item()

    def grads_close(got, ref, depth, scale=None) -> tuple[bool, dict]:
        """The JAX package's own bounds between its two backends (leaves rtol
        2e-3, view rtol 5e-2) plus an absolute term that scales with the
        largest reference entry, because the kernel contracts FMAs and the
        plain path does not: 1e-2 (leaves) and 2e-2 (view) of it for RGB,
        where the eps=1e-5 normal hands the taps cotangents ~1/(2e-5) times
        the pixel's that cancel in pairs, so any two float32 programs differ
        by noise on the scale of the scene's largest gradient; 2e-3 of it for
        depth, where only the march's compounding ulps remain. ``scale``
        overrides both shares (the full-size comparison states its own)."""
        (leaf, vw), (rleaf, rvw) = got[:2], ref[:2]
        scale_l, scale_v = float(np.abs(rleaf).max()), float(np.abs(rvw).max())
        leaf_atol = 1e-5 + (scale or (2e-3 if depth else 1e-2)) * scale_l
        view_atol = 1e-3 + (scale or (2e-3 if depth else 2e-2)) * scale_v
        stats = {
            "leaf_err_of_largest": float(np.abs(leaf - rleaf).max() / max(scale_l, 1e-30)),
            "view_err_of_largest": float(np.abs(vw - rvw).max() / max(scale_v, 1e-30)),
            "max_abs_err": float(max(np.abs(leaf - rleaf).max(), np.abs(vw - rvw).max())),
        }
        ok = (bool(np.isfinite(leaf).all() and np.isfinite(vw).all())
              and np.allclose(leaf, rleaf, rtol=2e-3, atol=leaf_atol)
              and np.allclose(vw, rvw, rtol=5e-2, atol=view_atol))
        return ok, stats

    union = st.sphere(0.8, color=(0.9, 0.4, 0.2)) | st.box(0.4).translate(1.0, 0.0, 0.0)
    bwd_cases = [("union", union, 24, 16)]
    for name in ("cell_colors", "palette"):
        bwd_cases += [(name, small[name](), w, h) for w, h in ((40, 24), (17, 13))]
    bwd_err = 0.0
    for name, expr, w, h in bwd_cases:
        for depth in (False, True):
            v = view((-2.0, 2.0, 4.0))
            ok, stats = grads_close(grads(expr, w, h, v, "kernel", depth),
                                    grads(expr, w, h, v, "torch", depth), depth)
            check(ok, f"{name} {'depth' if depth else 'rgb'} {w}x{h} backward kernel vs "
                      f"autograd of the plain path, every leaf and the view {stats}")
            if name == "union":
                bwd_err = max(bwd_err, stats["max_abs_err"])

    # -- 8. the slice at full size: fit on SphereRepeat 1920x1080x40. It runs
    #       before phase 7 so that it is the first to differentiate this
    #       structure, and its build count shows the one backward library.
    #       The target is the kernel's own frame at sphere radius 0.5, and the
    #       fit moves the radius alone, from 0.55. Not from 0.45 and not every
    #       leaf: this renderer's gradient has no silhouette term, and on this
    #       frame of repeated spheres the radius's gradient at 0.45 points
    #       away from the target (+2.45 where finite differences give -0.66 at
    #       192x108 on the CPU, tests/test_torch_fit.py; the JAX package's own
    #       gradient does the same), while the
    #       leaves already at their target values get grazing-ray noise that
    #       Adam turns into full-size steps. From 0.55 the radius's gradient
    #       agrees with finite differences.
    def fit_radius(steps):
        return st.fit(hero, target, steps=steps, view=hero_view,
                      optimizer=lambda leaves: torch.optim.Adam([leaves[0]], lr=2e-3))

    hero_view = view((-2.0, 2.0, 4.0))
    with torch.no_grad():
        target = st.RayMarcher(WIDTH, HEIGHT, hero, view=hero_view).render().clone()
        radius.fill_(START_RADIUS)
    check(st.leaves(hero)[0] is radius, "the sphere radius is the scene's first leaf")
    torch.cuda.synchronize()
    builds = build.BUILDS
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    result = fit_radius(FIT_STEPS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fwd_launches, bwd_launches = rk.LAUNCHES, rk.BWD_LAUNCHES
    bwd_lib = build.load_bwd(prog)
    fitted = result.sdf.a.child.radius.item()
    print(f"fit: {FIT_STEPS} steps at {WIDTH}x{HEIGHT}x40 in {fit_s:.3f} s (the backward's build "
          f"{bwd_lib.build_seconds} s included); losses {result.losses}; radius {START_RADIUS} -> "
          f"{fitted}; "
          f"backward registers per thread {bwd_lib.registers}, local memory {bwd_lib.local_memory}")
    check(fwd_launches == FIT_STEPS and bwd_launches == FIT_STEPS,
          f"{FIT_STEPS} fit steps went through the kernels "
          f"(LAUNCHES={fwd_launches}, BWD_LAUNCHES={bwd_launches})")
    check(build.BUILDS == builds + 1 and bwd_lib.build_seconds is not None,
          f"the fit built exactly the one backward library (builds {builds} -> {build.BUILDS})")
    check(all(np.isfinite(result.losses)) and result.losses[-1] < result.losses[0],
          f"the loss falls: {result.losses[0]:.6g} -> {result.losses[-1]:.6g}")
    check(0.5 < fitted < START_RADIUS, f"the radius moves toward 0.5: {fitted}")
    check(abs(radius.item() - START_RADIUS) < 1e-6, "fit left the caller's scene alone")
    # The same gradient through the plain path, at the largest frame whose
    # autograd tape fits in device memory.
    plain_size = None
    for w, h in ((WIDTH, HEIGHT), (960, 540), (480, 270)):
        with torch.no_grad():
            radius.fill_(0.5)
            small_target = st.RayMarcher(w, h, hero, view=hero_view).render().clone()
            radius.fill_(START_RADIUS)
        try:
            ref = grads(hero, w, h, hero_view, "torch", False, small_target)
            plain_size = (w, h)
        except torch.OutOfMemoryError:
            print(f"the plain path's autograd tape does not fit at {w}x{h}")
        if plain_size is not None:
            break
        for q in st.leaves(hero):
            q.grad = None
        torch.cuda.empty_cache()
    check(plain_size is not None, "the plain path's gradient fits at some size")
    if plain_size is not None:
        # This gradient is ill conditioned, whoever computes it: an ulp decides
        # on which side of a cell border or a silhouette a sample falls, and a
        # grazing ray's cotangent grows by (1 + grad d . rd) per step, so a
        # few rays carry a visible share of a 2M-pixel sum. The probe beside
        # each comparison says how much: the plain path against itself with
        # the camera moved by 1e-6 (two ulps of its position). At the full 40
        # iterations the kernels are held to 5e-2 of the largest entry, twice
        # what was measured (2.5e-2 leaves, 1.5e-2 view); at 8 iterations,
        # where rays stop short of the surfaces and many samples lie near cell
        # borders, both numbers are larger and are only printed. The JAX
        # package's bench gates its two backends against such a probe too.
        moved = view((-2.0, 2.0, 4.000001))
        for iters in (8, 40):
            ref = grads(hero, w, h, hero_view, "torch", False, small_target, iters)
            probe = grads(hero, w, h, moved, "torch", False, small_target, iters)
            got = grads(hero, w, h, hero_view, "kernel", False, small_target, iters)
            ok, stats = grads_close(got, ref, False, scale=5e-2)
            _, floor = grads_close(probe, ref, False, scale=5e-2)
            what = (f"fit gradient at {w}x{h} (the largest frame whose tape fits), {iters} "
                    f"iterations: kernel vs plain {stats}; loss {got[2]:.6g} vs {ref[2]:.6g}; "
                    f"plain vs plain with the camera moved by 1e-6 {floor}")
            if iters == 40:
                check(ok, what)
            else:
                print("INFO " + what)
        del ref, got, probe
    torch.cuda.empty_cache()

    # -- 7. determinism and finiteness at full size ---------------------------
    first = grads(hero, WIDTH, HEIGHT, hero_view, "kernel", False, target)
    second = grads(hero, WIDTH, HEIGHT, hero_view, "kernel", False, target)
    check(bool(np.isfinite(first[0]).all() and np.isfinite(first[1]).all()),
          f"the {WIDTH}x{HEIGHT} gradient is finite (largest leaf entry "
          f"{float(np.abs(first[0]).max()):.6g})")
    check(np.array_equal(first[0], second[0]) and np.array_equal(first[1], second[1]),
          "two backward launches give bit-identical gradients")

    # -- 9. times, in turns inside this one call ------------------------------
    def events(fn, warmup=WARMUP, timed=TIMED) -> float:
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(timed):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / timed

    cfg = marcher.config
    with torch.no_grad():
        params = torch.cat([q.reshape(-1) for q in st.leaves(hero)]).contiguous()
        v19 = rk.view19(hero_view, cfg)
        cot = (2.0 / target.numel()) * (marcher.render() - target).reshape(-1, 3).contiguous()
    bwd_launch_ms = events(lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot))

    def grad_step(w, h, backend, tgt):
        m = st.RayMarcher(w, h, hero, view=hero_view, backend=backend)

        def run():
            for q in st.leaves(hero):
                q.grad = None
            torch.mean((m.render() - tgt) ** 2).backward()
        return run

    def backward_only(w, h, backend, tgt) -> float:
        """The backward pass alone: the loss is built outside the events."""
        m = st.RayMarcher(w, h, hero, view=hero_view, backend=backend)
        total = 0.0
        for i in range(WARMUP + TIMED):
            loss = torch.mean((m.render() - tgt) ** 2)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            loss.backward()
            stop.record()
            torch.cuda.synchronize()
            if i >= WARMUP:
                total += start.elapsed_time(stop)
        return total / TIMED

    pw, ph = plain_size if plain_size is not None else (480, 270)
    grad_rounds = {"plain": [], "kernel": [], "kernel_full": []}
    bwd_rounds = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        backend = "torch" if which == "plain" else "kernel"
        grad_rounds[which].append(events(grad_step(pw, ph, backend, small_target), 2, 5))
        bwd_rounds[which].append(backward_only(pw, ph, backend, small_target))
    grad_rounds["kernel_full"].append(events(grad_step(WIDTH, HEIGHT, "kernel", target)))
    grad_ms = float(np.mean(grad_rounds["kernel_full"]))
    plain_bwd_ms = float(np.mean(bwd_rounds["plain"]))

    def fit_steps(n):
        t0 = time.perf_counter()
        fit_radius(n)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    fit_steps(3)
    fit_step_ms = fit_steps(20)
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing backward launch alone (pullback + reduction kernels): {bwd_launch_ms:.4f} "
          f"ms at {WIDTH}x{HEIGHT}x40 on {smi}")
    print(f"timing forward+backward through RayMarcher + .backward(): {grad_ms:.4f} ms at "
          f"{WIDTH}x{HEIGHT}x40 on {smi}")
    print(f"timing one fit step (host clock, 20 steps, loss fetched every step): "
          f"{fit_step_ms:.4f} ms at {WIDTH}x{HEIGHT}x40 on {smi}")
    for which in ("kernel", "plain"):
        print(f"timing {which} forward+backward at {pw}x{ph}x40: "
              f"{float(np.mean(grad_rounds[which])):.4f} ms (rounds {grad_rounds[which]}); "
              f"backward alone {float(np.mean(bwd_rounds[which])):.4f} ms "
              f"(rounds {bwd_rounds[which]}) on {smi}")

    # Where a fit step's time goes: a profile of 5 steps.
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fit_radius(FIT_STEPS)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
            if getattr(e, "self_device_time_total", 0) > 0
            and "cuda" in str(e.device_type).lower()]
    device_ms = sum(ms for _, ms, _ in rows)
    if device_ms > 0:
        busy = device_ms / FIT_STEPS
        print(f"profile of {FIT_STEPS} fit steps: device busy {busy:.4f} ms per step; against the "
              f"{fit_step_ms:.4f} ms step timed without the profiler the device idles "
              f"{1.0 - busy / fit_step_ms:.3f} of a step (wall with the profiler on: "
              f"{wall_ms / FIT_STEPS:.4f} ms per step)")
        for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
            print(f"  {ms / FIT_STEPS:9.4f} ms/step  x{count / FIT_STEPS:g}  {key[:90]}")
    else:
        print("profile: the profiler showed no device time; idle share not measured")
    with torch.no_grad():
        radius.fill_(0.5)
    torch.cuda.synchronize()

    # -- bounds: the least time the card could take for the same work ---------
    from sdfkit_tpu_torch.sdf.compile import operation_counts

    ops_n = operation_counts(prog)
    npix = WIDTH * HEIGHT
    with torch.no_grad():
        hits = int((marcher.render_depth() <= cfg.far).sum())
    n = cfg.depth_iterations
    shade_ops = 60  # ray, normalisations, Lambert and the sky select of one pixel
    step_ops = 7  # ro + rd * depth, and the depth's own add
    # Forward: every pixel marches n-1 steps, evaluates colour once and taps 6 times.
    fwd_ops = npix * ((n - 1 + 6) * (ops_n["dist"] + step_ops) + ops_n["eval"] + shade_ops)
    fwd_bytes = npix * 12 + 4 * (prog.n_params + 19)
    # Backward: every pixel replays the march and the colour step; only a hit
    # pixel taps, pulls the taps and the colour step back and sweeps the march.
    bwd_ops = (npix * ((n - 1) * (ops_n["dist"] + step_ops) + ops_n["eval"] + 30)
               + hits * (6 * (ops_n["dist"] + step_ops) + (6 + n - 1) * (ops_n["dist_vjp"] + 20)
                         + ops_n["eval_vjp"] + 3 * shade_ops))
    bwd_bytes = npix * 12 + 4 * (prog.n_params + 19) * 2
    print(f"work: {ops_n} operations per call; {hits} of {npix} pixels hit; forward "
          f"{fwd_ops:.4g} operations / {fwd_bytes} bytes, backward {bwd_ops:.4g} / {bwd_bytes}")

    def bound(ops_count, nbytes):
        by_ops, by_bytes = ops_count / PEAK_FP32_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
        return max(by_ops, by_bytes), "operations" if by_ops >= by_bytes else "bytes"

    fwd_bound, fwd_by = bound(fwd_ops, fwd_bytes)
    bwd_bound, bwd_by = bound(bwd_ops, bwd_bytes)

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(smi)
    print(json.dumps({"kernels": [
        {"name": "raymarch_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches, "launches_in_fit": fwd_launches,
         "max_abs_err": full_stats["max"], "ms": launch_ms, "frame_ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None},
        {"name": "raymarch_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES, "launches": bwd_launches, "max_abs_err": bwd_err,
         "ms": bwd_launch_ms, "plain_ms": plain_bwd_ms, "plain_shape": [pw, ph],
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
