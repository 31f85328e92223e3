#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Builds the hand-written kernels from the sources in this checkout and drives
every path of the port at full size, SphereRepeat at 1920x1080 with 40
iterations:

1-5  the forward: the kernel against the plain PyTorch path and the
     committed goldens, a scene too large for the constant bank (its
     parameters in device memory) through every entry point that renders, a
     parameter edit that rebuilds nothing, a frame through
     ``RayMarcher(backend="auto")``, and its time;
6    the backward kernel against autograd of the plain path on the card,
     every leaf and the view, RGB and depth, on small scenes; the scene of
     16,506 slots differentiated and fitted through the kernels;
7    two backward launches at full size: bit-identical, finite gradients;
8    ``fit`` for 5 steps at full size through the two kernels, and the
     gradient against the plain path's at the largest frame whose autograd
     tape fits;
9    times with CUDA events, and a profile of the fit steps;
10   the ray-batch forward kernel on the frame's camera rays and on rays that
     are no camera's, against the plain path and the image kernel; the
     frame's rays shuffled, and the kernel's own depth history (its depth
     renders of 1 to 39 iterations) with each ray's settled step;
11   the ray-batch pullback (a tangent march) against autograd of the plain
     path (every leaf, ``ro``, ``rd``) on small frames and, fed one
     cotangent, at full size; two launches and launches in pieces
     bit-identical, a gradient step through ``render_rays_kernel``; the
     forward's hit flags, the pullback with and without them, and the rays
     whose march ends at another depth than the forward's;
12   the depth-history handoff: the forward's store against ``march_history``
     (small frames and full size) and against depth renders of fewer
     iterations, the store-fed backward (its depths staged in shared memory)
     against autograd of the plain path and against the replay, on two bands
     of an odd pixel count, and the four times;
13   two row bands and nine resumable tiles against the whole frame, bit for
     bit, with three tiles deleted and resumed;
14   ``sample`` of 1,000,003 points and ``voxelize`` at 256^3 on the card
     against the CPU;
15   gradients at 80 and 130 march iterations (more than the image backward
     keeps depths for at once) through ``RayMarcher``, ``render_rays_kernel``,
     the store-fed backward and ``fit`` against autograd of the plain path;
16   what the compiler made of the six libraries: registers, resident blocks
     per SM, and the instructions of the march, sweep and tangent loops from
     SASS;
17   meshing: SphereRepeat voxelized on the card over [-2, 2]^3 at 256^3 and
     512^3 and meshed through ``SdfExpr.to_mesh`` and ``Voxels.to_mesh`` (the
     dense phase and the colour blends on the card, the C++ sparse phase on
     the host); at 256^3 the mesh against the numpy oracle on the grid fetched
     to the host and its OBJ's line counts; at both sizes the vertex count
     against the sequential C++ baseline, which is timed; ``step=2`` and an
     iso of 0.5 on a 96^3 grid, the card's mesh against the CPU's; times
     (min of 3 after a warm-up) with the phase split;
18   registration: ICP on bench.py's cloud at 10,000 and 100,000 points, the
     device loop with brute-force and grid search against the host parity
     loop and the static cloud (1e-4), the grid index against brute force on
     100,000 queries, a gradient through ``register_points_torch``; times on
     the host clock and with CUDA events, iteration counts, the 3x3 SVD on the
     card and on the host, and the card's idle share in a registration;
19   the sharded paths (``sdfkit_tpu_torch.parallel``) over 4 ranks on this
     card in one ``gloo`` group, through ``tools/torch_distributed_demo.py``
     (the SphereRepeat libraries built here first, so no rank runs nvcc):
     ``render_sharded`` RGB and depth at 1920x1080 and a small odd frame, 4K
     depth, nine tiles over the mesh (and resumed on one rank) bit for bit,
     ``train_step_sharded`` and ``fit(mesh=)`` against one rank,
     ``voxelize_sharded`` at 256^3 and 512x128x128 and ``create_mesh_sharded``
     on the 256^3 bricks array-equal to one device's, the image kernels
     launched once per rank's band, with times beside one rank's; then an
     NCCL group of one rank in this process;
20   the viewer (``tools/torch_view.py``): a ``LiveViewer`` of SphereRepeat
     at 1920x1080 served from a thread, ten ``/frame.png`` decoded and held
     bit for bit to the quantised ``RayMarcher.render`` of the same orbit
     views (one image-forward launch a frame, no plain render), one
     ``/stream`` part, ``/stats``, the shutdown, the CLI's ``--orbit 3`` and a
     ``.tga`` frame; render, PNG encode and stream times;
21   the scaling harness (``tools/torch_scaling.py``) at 1920x1080x40 over 1,
     2 and 4 ranks on this card (one launch of 4 ranks in a ``gloo`` group):
     frames bit for bit against one rank's, one launch per rank and frame,
     no nvcc on a rank, the static work against the "work:" lines'; each
     point's ms, Mrays/s, efficiencies and band ms per rank;
22   the benchmark (``bench_torch.py``) in a subprocess, every kernel built
     here first: exit code 0, its section lines in order, its headline
     (``correct``, this card), no nvcc and no file written in the checkout;
23   on a machine of two or more cards, the sharded paths over NCCL with a
     card for each rank (up to four): first, in this process, a 1080p frame
     (RGB and depth) and a gradient step through ``RayMarcher`` on every card
     (0, the last, 0, 1, the rest), bit-identical to card 0's; then
     ``tools/torch_distributed_demo.py --size cards`` (phase 19's checks and
     bounds, plus a 4K RGB frame and the bricks and the mesh at 512^3 against
     one device, 1,215,992 vertices), every rank on its own card (by PCI
     address) in one NCCL group, no nvcc on a rank; then
     ``tools/torch_scaling.py --process-group nccl`` over 1, 2 and 4 cards at
     1920x1080 and 3840x2160. Its ``sharded_cards`` line has each path's host
     ms beside one rank's, the collectives alone, the bands and the walltime
     efficiencies. On one card it prints that it did not run, and why;
24   the fitting-sized scene, ``scenes.union_grid_scene()`` (200 spheres,
     1,400 parameter slots: the backward's large-scene tier), at 1920x1080x40
     from the default camera: the frame through ``RayMarcher`` against the
     plain path, the gradient against autograd of the plain path (every leaf
     and the view on a 64x36 frame, and at 1080p with the cotangent on 16,384
     seeded pixels), two backward launches bit for bit, ``fit`` of the 600
     colour scalars toward another colour table, the store-fed and ray-batch
     forms once, and each library's nvcc seconds, registers and local memory
     and each kernel's time against its bound. Its six libraries build from
     the start of the run in a process of their own
     (``chip_smoke.py --build-union-grid``), beside phases 1-23.

Scenes are built with no device argument: the package's default device is
the card. The script imports nothing of JAX. It exits non-zero, with no
result line, when there is no CUDA device or any check fails; on success it
prints one JSON line each for ``mesh``, ``icp``, ``sharded``, ``view``,
``scaling``, ``sharded_cards`` (``"ran": false`` on one card) and
``union_grid``, the card's name and power limit, one line of JSON that lists
the six kernels, and last
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import pathlib
import shutil
import subprocess
import sys
import tempfile
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
REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:355"
BWD_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_bwd.cu"
BWD_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:480"
RAYS_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_rays_fwd.cu"
RAYS_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:198"
RAYS_BWD_SOURCE = "sdfkit_tpu_torch/csrc/raymarch_rays_bwd.cu"
RAYS_BWD_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:842"
STORE_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:357"
STORE_BWD_REPLACES = "sdfkit_tpu/render/pallas/raymarch_kernel.py:516"
TILE_ROWS = 128
SAMPLE_POINTS = 1_000_003
SAMPLE_BATCH = 1 << 18  # an explicit cap: three full batches and a remainder of 213,571
GRID = 256
MESH_GRIDS = (256, 512)
# The JAX package's vertex counts of the same meshes (BENCH_r05.json, on a TPU):
# a cross-check only, since the card's voxelize may move a value near 0 by an ulp.
JAX_MESH_VERTICES = {256: 300_152, 512: 1_215_992}
ICP_POINTS = (10_000, 100_000)
SLEEP_CYCLES = 40_000_000  # about 20 ms at 1980 MHz, ahead of launches timed on the card

FAILURES: list[str] = []
CHILDREN: list[subprocess.Popen] = []  # stopped on the way out, whatever happened


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


def host_ms(fn):
    """(fn(), milliseconds) on the host clock, the card idle at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn) -> float:
    """One call of ``fn`` between two CUDA events, in milliseconds."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def meshes_equal(a, b, normals_atol=0.0, colors_atol=0.0) -> tuple[bool, dict]:
    """Vertices and triangles identical, normals and colours within the bounds."""
    stats = {"vertices": [len(a.vertices), len(b.vertices)],
             "triangles": [len(a.triangles), len(b.triangles)]}
    if stats["vertices"][0] != stats["vertices"][1] or stats["triangles"][0] != stats["triangles"][1]:
        return False, stats
    stats["normals_max_abs_err"] = float(np.abs(a.normals - b.normals).max(initial=0.0))
    stats["colors_max_abs_err"] = float(np.abs(a.colors - b.colors).max(initial=0.0))
    ok = (np.array_equal(a.vertices, b.vertices) and np.array_equal(a.triangles, b.triangles)
          and stats["normals_max_abs_err"] <= normals_atol
          and stats["colors_max_abs_err"] <= colors_atol)
    return ok, stats


def phase_mesh(st, smi: str) -> dict:
    """Phase 17: SphereRepeat meshed on the card at 256^3 and 512^3."""
    from sdfkit_tpu_torch import native, scenes
    from sdfkit_tpu_torch.mesh import marching_cubes as mc

    hero = scenes.sphere_repeat_scene()
    lo, hi = (-2.0,) * 3, (2.0,) * 3
    # The C++ geometry starts a worker per 16,384 active cells, up to the
    # hardware threads the host reports.
    out = {"scene": "SphereRepeat over [-2, 2]^3", "gpu": smi, "host_cpus": os.cpu_count(),
           "host_cpus_usable": len(os.sched_getaffinity(0))}
    for n in MESH_GRIDS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m_expr, expr_ms = host_ms(lambda: hero.to_mesh(lo, hi, n, n, n))
        expr_peak = torch.cuda.max_memory_allocated()
        with torch.no_grad():
            vox, vox_ms = host_ms(lambda: st.voxelize(hero, lo, hi, n, n, n))
        check(vox.values.is_cuda and vox.colors.is_cuda, f"the {n}^3 volume is on the card")
        vox.to_mesh()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):
            m, ms = host_ms(vox.to_mesh)
            runs.append((ms, dict(mc.LAST_TIMINGS)))
        mesh_peak = torch.cuda.max_memory_allocated()
        best_ms, split = min(runs, key=lambda r: r[0])
        ok, _ = meshes_equal(m, m_expr)
        check(ok, f"SdfExpr.to_mesh and Voxels.to_mesh give one mesh at {n}^3")
        values_h, colors_h = vox.values.cpu().numpy(), vox.colors.cpu().numpy()
        t0 = time.perf_counter()
        seq_verts, seq_stream = native.mc_sequential_baseline(values_h, colors_h, 1, 0.0)
        seq_ms = (time.perf_counter() - t0) * 1e3
        check(seq_verts == len(m.vertices) and seq_stream == len(m.triangles),
              f"{n}^3: {len(m.vertices)} vertices and {len(m.triangles) // 3} triangles, the "
              f"sequential C++ baseline's {seq_verts} and {seq_stream // 3}")
        entry = {
            "vertices": len(m.vertices), "triangles": len(m.triangles) // 3,
            "jax_package_vertices_info": JAX_MESH_VERTICES[n],
            "to_mesh_ms_min_of_3": best_ms, "to_mesh_ms_runs": [r[0] for r in runs],
            "split_ms": split, "voxelize_ms": vox_ms,
            "sdf_expr_to_mesh_ms_first_call": expr_ms,
            "sequential_cpp_baseline_ms": seq_ms,
            "peak_device_bytes_expr_to_mesh": expr_peak, "peak_device_bytes_to_mesh": mesh_peak,
        }
        print(f"mesh {n}^3: {len(m.vertices)} vertices (the JAX package's run: "
              f"{JAX_MESH_VERTICES[n]}), to_mesh {best_ms:.3f} ms (min of 3 after a warm-up; "
              f"runs {[round(r[0], 3) for r in runs]}), split {split}; voxelize {vox_ms:.3f} ms; "
              f"SdfExpr.to_mesh (voxelize and mesh, first call) {expr_ms:.3f} ms; sequential C++ "
              f"baseline {seq_ms:.3f} ms on the host; peak device memory {expr_peak / 2**30:.2f} "
              f"GiB through SdfExpr.to_mesh, {mesh_peak / 2**30:.2f} GiB meshing; on {smi}")
        if n == 256:
            t0 = time.perf_counter()
            ref = mc.create_mesh_numpy(values_h, colors_h, vox.vmin, vox.vmax)
            entry["numpy_oracle_ms"] = (time.perf_counter() - t0) * 1e3
            ok, stats = meshes_equal(m, ref, normals_atol=2e-5, colors_atol=1e-6)
            entry["against_numpy_oracle"] = stats
            check(ok, f"256^3 mesh equals the numpy oracle's on the grid fetched to the host "
                      f"(normals within 2e-5, colours within 1e-6): {stats}")
            with tempfile.TemporaryDirectory() as d:
                path = pathlib.Path(d) / "sphere_repeat.obj"
                t0 = time.perf_counter()
                m.write_obj(path)
                entry["write_obj_ms"] = (time.perf_counter() - t0) * 1e3
                counts = {"v": 0, "vn": 0, "f": 0}
                with open(path) as f:
                    for line in f:
                        key = line.split(" ", 1)[0]
                        if key in counts:
                            counts[key] += 1
            entry["obj_lines"] = counts
            check(counts == {"v": len(m.vertices), "vn": len(m.vertices),
                             "f": len(m.triangles) // 3},
                  f"the OBJ holds v / vn / f lines {counts} for the mesh's "
                  f"{len(m.vertices)} vertices and {len(m.triangles) // 3} triangles")
        out[f"{n}^3"] = entry
        del vox, values_h, colors_h, m, m_expr
    # step=2 and an iso offset on a small grid: the card's mesh is the CPU's.
    with torch.no_grad():
        small = st.voxelize(hero, lo, hi, 96, 96, 96, clip_to_bounds=False)
    cpu = st.Voxels(*(t.cpu() for t in (small.values, small.colors, small.vmin, small.vmax)))
    for kw in ({"step": 2}, {"iso_value": 0.5}, {"step": 2, "iso_value": 0.5}):
        ok, stats = meshes_equal(small.to_mesh(**kw), cpu.to_mesh(**kw), colors_atol=1e-6)
        check(ok and stats["vertices"][0] > 0,
              f"96^3 {kw}: the card's mesh is the CPU's (colours within 1e-6): {stats}")
    return out


def icp_cloud(n: int):
    """bench.py's cloud: seed 7, uniform in [-1, 1]^3, rotated 0.02 rad about
    z and moved by (0.03, -0.02, 0.01)."""
    rng = np.random.default_rng(7)
    static = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ang = 0.02
    rot = np.array([[np.cos(ang), np.sin(ang), 0], [-np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    return static, static @ rot + np.float32([0.03, -0.02, 0.01])


def phase_icp(st, smi: str) -> dict:
    """Phase 18: ICP on the card at 10,000 and 100,000 points."""
    from sdfkit_tpu_torch.registration import icp

    dev = st.default_device()
    out = {"cloud": "seed 7, uniform in [-1, 1]^3, 0.02 rad about z, moved (0.03, -0.02, 0.01)",
           "gpu": smi}
    for n in ICP_POINTS:
        static_h, moved_h = icp_cloud(n)
        static = torch.from_numpy(static_h).to(dev)
        moved = torch.from_numpy(moved_h).to(dev)
        entry = {}

        # The host parity loop (float64 numpy, the search on the card).
        reg = st.IterativeClosestPoint(static_h)
        check(reg._nn.device.type == "cuda", f"ICP {n}: the static points are on the card")
        reg.register_points(moved_h, parity=True)  # warm-up
        calls = []
        step = reg._iter_transform
        reg._iter_transform = lambda pts: calls.append(1) or step(pts)
        (a_host, t_host), ms = host_ms(lambda: reg.register_points(moved_h, parity=True))
        entry["host_loop"] = {"ms": ms, "iterations": len(calls)}
        del reg._iter_transform

        for mode in ("brute", "grid"):
            grid = icp.GridNN(static) if mode == "grid" else None
            searches = []  # one search an iteration (and the grid's repairs)

            def run():
                searches.clear()
                with torch.no_grad():
                    return icp.register_points_torch(static, moved, nn=mode, grid=grid)

            if grid is not None:
                query = grid.query
                grid.query = lambda q: searches.append(1) or query(q)
            else:
                brute = icp.nearest_neighbors
                icp.nearest_neighbors = lambda *a, **k: searches.append(1) or brute(*a, **k)

            rounds = 1 if (mode == "brute" and n > 10_000) else 3
            if rounds > 1:
                run()  # warm-up
            timings = []
            for _ in range(rounds):
                (aligned, total), wall = host_ms(run)
                timings.append((wall, event_ms(run)))
            iterations = len(searches)
            if grid is None:
                icp.nearest_neighbors = brute
            aligned_h, total_h = aligned.cpu().numpy(), total.cpu().numpy()
            err_t = float(np.abs(total_h - t_host).max())
            err_a = float(np.abs(aligned_h - a_host).max())
            err = float(np.abs(aligned_h - static_h).max())
            check(err_t <= 1e-4 and err_a <= 1e-4,
                  f"ICP {n} nn={mode}: the device loop is the host loop's within 1e-4 "
                  f"(transform {err_t:.3g}, points {err_a:.3g})")
            check(err <= 1e-4, f"ICP {n} nn={mode}: aligned points within 1e-4 of the static "
                               f"cloud (max error {err:.3g})")
            entry[mode] = {"ms_host_clock": min(t[0] for t in timings),
                           "ms_cuda_events": min(t[1] for t in timings),
                           "rounds": [list(t) for t in timings],
                           "iterations": iterations, "max_err_vs_static": err,
                           "vs_host_loop": [err_t, err_a]}
            if grid is not None:
                per = icp.GRID_QUERY_CANDIDATES // (27 * grid.K)  # query's own chunks
                entry[mode]["doubtful_queries_first_iteration"] = sum(
                    int((~grid._grid_pass(moved[s:s + per])[1]).sum()) for s in range(0, n, per))
        # The user's entry point: register_points picks the device loop here.
        _, ms = host_ms(lambda: st.IterativeClosestPoint(static_h).register_points(moved_h))
        entry["register_points_ms"] = ms

        if n == max(ICP_POINTS):
            grid = icp.GridNN(static)
            (gi, gd), g_ms = host_ms(lambda: grid.query(moved))
            (bi, bd), b_ms = host_ms(lambda: icp.nearest_neighbors(static, moved))
            same = bool(torch.equal(gi, bi))
            rel = float(((gd - bd).abs() / bd.clamp(min=1e-30)).max())
            check(same and rel <= 2e-7, f"GridNN against brute force, {n} queries on the card: "
                                        f"indices identical {same}, distances rtol {rel:.3g}")
            entry["grid_query_ms"], entry["brute_query_ms"] = g_ms, b_ms
        else:
            mv = moved.clone().requires_grad_()
            aligned, _ = icp.register_points_torch(static, mv, max_iterations=10)
            ((aligned - static) ** 2).sum().backward()
            check(bool(torch.isfinite(mv.grad).all()) and float(mv.grad.abs().sum()) > 0,
                  f"ICP {n}: a finite gradient through register_points_torch")
            # What the 3x3 Kabsch costs on the card and on the host.
            c = torch.randn(3, 3, device=dev)
            svd_ms = min(event_ms(lambda: [torch.linalg.svd(c) for _ in range(100)])
                         for _ in range(3)) / 100
            c_h = c.double().cpu().numpy()
            t0 = time.perf_counter()
            for _ in range(1000):
                np.linalg.svd(c_h)
            entry["svd3x3_ms_card"] = svd_ms
            entry["svd3x3_ms_host_float64"] = (time.perf_counter() - t0) / 1000 * 1e3
            # How long the card idles in a registration (one host read a step):
            # the profiler's busy time over the registration's time without the
            # profiler, which slows the host's side of a run.
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                _, wall = host_ms(lambda: icp.register_points_torch(static, moved, nn="brute"))
            busy = sum(e.self_device_time_total for e in prof.key_averages()
                       if getattr(e, "self_device_time_total", 0) > 0
                       and "cuda" in str(e.device_type).lower()) / 1e3
            plain_wall = entry["brute"]["ms_host_clock"]
            entry["profile_brute"] = {"wall_ms_profiled": wall, "wall_ms": plain_wall,
                                      "device_busy_ms": busy,
                                      "idle_share": 1.0 - busy / plain_wall if busy > 0 else None}
        print(f"icp {n}: {json.dumps(entry)} on {smi}")
        out[str(n)] = entry
    return out


SHARDED_RANKS = 4
SHARDED_TIMEOUT = 600.0


def sharded_launches(line: dict, which: int) -> dict:
    """Phase 19's launches of the image forward (``which`` 0) or backward (1),
    summed over the ranks, of the sharded frame, train step and fit steps."""
    per_rank = line.get("launches_per_rank", {})
    keys = [k for k in per_rank if k.startswith(("k_render_sharded_1920", "k_train_step",
                                                 "k_fit_mesh"))]
    return {"ranks": line["ranks"], "backend": line["backend"],
            **{k: sum(r[which] for r in per_rank[k]) for k in keys}}


def phase_sharded(st, smi: str) -> dict:
    """Phase 19: the sharded paths over 4 ranks on this one card (a gloo
    group), through tools/torch_distributed_demo.py, and an NCCL group of
    one rank in this process."""
    import torch.distributed as dist

    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.parallel import distributed
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
    from sdfkit_tpu_torch.sdf.compile import compile_scene

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_distributed_demo as demo

    hero = scenes.sphere_repeat_scene()
    prog = compile_scene(hero)
    # The SphereRepeat libraries the ranks load: built here (phases 1-8 did),
    # so that no rank runs nvcc.
    build.load(prog)
    build.load_bwd(prog)
    out = {"ranks": SHARDED_RANKS, "backend": "gloo", "device": "cuda:0 (shared)", "gpu": smi}
    t0 = time.perf_counter()
    try:
        reports = demo.launch(SHARDED_RANKS, device="cuda", size="full", backend="gloo",
                              timeout=SHARDED_TIMEOUT, echo=True)
    except RuntimeError as e:
        print(str(e)[-8000:], file=sys.stderr)
        check(False, f"{SHARDED_RANKS} ranks on one card ran every sharded check")
        return out
    out["seconds"] = time.perf_counter() - t0
    failed = [what for r in reports for ok, what in r["checks"] if not ok]
    n_checks = sum(len(r["checks"]) for r in reports)
    check(not failed and n_checks > 0,
          f"{SHARDED_RANKS} ranks in one gloo group on {reports[0]['device']}: {n_checks} checks "
          f"passed on the ranks in {out['seconds']:.1f} s (CUDA start of every rank included)")
    check(all(r["backend"] == "gloo" and r["ranks"] == SHARDED_RANKS for r in reports)
          and all(r["nvcc_builds"] == 0 for r in reports),
          f"every rank joined the gloo group of {SHARDED_RANKS} and built nothing "
          f"(nvcc runs {[r['nvcc_builds'] for r in reports]})")
    launches = {k: [r["launches"][k] for r in reports] for k in reports[0]["launches"]}
    out["launches_per_rank"] = launches
    # One image forward per rank and frame; in a gradient step one forward
    # and one backward per rank, each over the rank's band.
    frame = f"k_render_sharded_{demo.SIZES['full']['width']}x{demo.SIZES['full']['height']}"
    steps = demo.SIZES["full"]["fit_steps"]
    check(launches[frame] == [[1, 0]] * SHARDED_RANKS
          and launches["k_train_step_sharded"] == [[1, 1]] * SHARDED_RANKS
          and launches["k_fit_mesh"] == [[steps, steps]] * SHARDED_RANKS
          and all(f == 1 for f, _ in launches["render_sharded_depth_4k"]),
          f"the sharded frame, train step and fit(mesh=) went through the kernels once per rank's "
          f"band: {launches}")
    out["mesh_vertices"] = reports[0]["mesh_vertices"]
    check(reports[0]["mesh_vertices"] == JAX_MESH_VERTICES[256],
          f"create_mesh_sharded at 256^3: {reports[0]['mesh_vertices']} vertices "
          f"({JAX_MESH_VERTICES[256]} expected)")
    out["errors"] = reports[0]["errors"]
    out["times"] = reports[0]["times"]
    for name, t in reports[0]["times"].items():
        one = (f"one rank min {min(t['one_rank_ms']):.3f} ms "
               f"{[round(x, 3) for x in t['one_rank_ms']]}" if t["one_rank_ms"] else "")
        print(f"sharded {name}: {SHARDED_RANKS} ranks (gloo, one card) min "
              f"{min(t['ranks_ms']):.3f} ms {[round(x, 3) for x in t['ranks_ms']]}; {one}; "
              f"on {smi}")

    # -- an NCCL group of one rank, in this process: the collectives run (a
    #    group of one still calls them) and the results are one device's.
    with tempfile.TemporaryDirectory() as d:
        par.initialize(f"file://{d}/nccl", backend="nccl", world_size=1, rank=0)
        try:
            mesh = par.make_mesh()
            one = distributed.single(mesh.device)
            eye = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
            with torch.no_grad():
                target = st.RayMarcher(WIDTH, HEIGHT, hero, view=eye).render().clone()
                start = scenes.sphere_repeat_scene()
                st.leaves(start)[0].fill_(START_RADIUS)
            torch.cuda.synchronize()
            rk.LAUNCHES = rk.BWD_LAUNCHES = 0
            frame_img = par.render_sharded(mesh, hero, WIDTH, HEIGHT, view=eye)
            new, loss = par.train_step_sharded(mesh, start, target, view=eye)
            torch.cuda.synchronize()
            nccl_launches = (rk.LAUNCHES, rk.BWD_LAUNCHES)
            ref, ref_loss = par.train_step_sharded(one, start, target, view=eye)
            bricks = par.voxelize_sharded(mesh, hero, (-2.0,) * 3, (2.0,) * 3, 64, 64, 64)
            whole = bricks.gather()
            with torch.no_grad():
                vox = st.voxelize(hero, (-2.0,) * 3, (2.0,) * 3, 64, 64, 64)
            same_leaves = all(torch.equal(a, b) for a, b in zip(st.leaves(new), st.leaves(ref)))
            check(mesh.backend == "nccl" and mesh.size == 1 and mesh.device.type == "cuda"
                  and torch.equal(frame_img, target) and loss.item() == ref_loss.item()
                  and same_leaves and torch.equal(whole.values, vox.values)
                  and nccl_launches == (2, 1),
                  f"an NCCL group of one rank on {mesh.device}: the 1920x1080 frame, the train step "
                  f"(loss {loss.item():.7g}) and the 64^3 bricks gathered through NCCL equal one "
                  f"device's bit for bit; launches {nccl_launches}")
            ms = []
            for _ in range(5):
                _, t = host_ms(lambda: par.render_sharded(mesh, hero, WIDTH, HEIGHT, view=eye))
                ms.append(t)
            out["nccl_one_rank_frame_ms"] = ms
        finally:
            dist.destroy_process_group()
    return out


VIEW_FRAMES = 10
STREAM_PARTS = 5
SCALING_DEVICES = (1, 2, 4)


def read_stream_part(f) -> bytes:
    """The body of one part of the viewer's multipart stream."""
    if f.readline() != b"--frame\r\n":
        raise RuntimeError("the stream's part does not start with its boundary")
    headers = {}
    while (line := f.readline()) not in (b"\r\n", b""):
        key, value = line.decode().split(":", 1)
        headers[key.strip().lower()] = value.strip()
    if headers.get("content-type") != "image/png":
        raise RuntimeError(f"a stream part of type {headers.get('content-type')}")
    body = f.read(int(headers["content-length"]))
    f.read(2)
    return body


def phase_view(st, smi: str) -> dict:
    """Phase 20: tools/torch_view.py on the card: a LiveViewer of SphereRepeat
    at 1920x1080 served from a thread, its frames and stream against
    RayMarcher.render, then the CLI's orbit and TGA output."""
    import socket
    import threading
    import urllib.request

    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.io.png import decode_png, encode_png, quantize, quantize_tensor
    from sdfkit_tpu_torch.io.tga import read_tga
    from sdfkit_tpu_torch.render import raymarch
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_view

    hero = scenes.sphere_repeat_scene()
    builds = build.BUILDS
    viewer = torch_view.LiveViewer(hero, WIDTH, HEIGHT)
    server = torch_view.serve(viewer, 0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    threads_before = set(threading.enumerate())
    server_thread = threading.Thread(target=server.serve_forever, daemon=True)
    server_thread.start()
    out = {"size": [WIDTH, HEIGHT], "gpu": smi, "png_level": viewer.PNG_LEVEL}
    # A plain render would go through render_image_torch: count its calls.
    plain_calls = []
    plain = raymarch.render_image_torch
    raymarch.render_image_torch = lambda *a, **k: plain_calls.append(1) or plain(*a, **k)
    try:
        torch.cuda.synchronize()
        rk.LAUNCHES = 0
        frames, render_ms, fetch_ms = [], [], []
        for _ in range(VIEW_FRAMES):
            t0 = time.perf_counter()
            data = urllib.request.urlopen(f"{base}/frame.png", timeout=60).read()
            fetch_ms.append((time.perf_counter() - t0) * 1e3)
            render_ms.append(viewer.last_render_ms)
            frames.append(decode_png(data))
        launches = rk.LAUNCHES
        # One part of the stream, its pace over STREAM_PARTS parts, and close.
        sock = socket.create_connection(server.server_address, timeout=60)
        try:
            sock.sendall(b"GET /stream HTTP/1.1\r\nHost: localhost\r\n\r\n")
            f = sock.makefile("rb")
            while f.readline() not in (b"\r\n", b""):
                pass
            parts = [read_stream_part(f)]
            t0 = time.perf_counter()
            for _ in range(STREAM_PARTS - 1):
                parts.append(read_stream_part(f))
            stream_fps = (STREAM_PARTS - 1) / (time.perf_counter() - t0)
            handlers = [t for t in threading.enumerate()
                        if t not in threads_before and t is not server_thread]
        finally:
            sock.close()
        stats = json.loads(urllib.request.urlopen(f"{base}/stats", timeout=60).read())
    finally:
        raymarch.render_image_torch = plain
        server.shutdown()
    for t in [server_thread, *handlers]:
        t.join(timeout=30)
    server.server_close()
    check(handlers and not any(t.is_alive() for t in [server_thread, *handlers]),
          f"the viewer's server thread and its {len(handlers)} handler thread(s) ended after "
          f"shutdown()")

    marcher = st.RayMarcher(WIDTH, HEIGHT, hero)
    with torch.no_grad():
        refs = [quantize_tensor(marcher.render(camera=viewer.view(i))).cpu().numpy()
                for i in range(VIEW_FRAMES + 1)]
        frame0 = marcher.render(camera=viewer.view(0))
        on_host = quantize(frame0.cpu().numpy())
    check(all(f.shape == (HEIGHT, WIDTH, 3) and np.array_equal(f, r)
              for f, r in zip(frames, refs)),
          f"{VIEW_FRAMES} served {WIDTH}x{HEIGHT} frames (/frame.png, decoded) equal the "
          f"quantised RayMarcher.render(camera=view_i) of the same orbit views bit for bit")
    check(np.array_equal(refs[0], on_host),
          "quantize_tensor on the card equals write_png's numpy formula on the same frame")
    check(launches == VIEW_FRAMES and not plain_calls and marcher.backend == "kernel",
          f"the viewer launched the image forward {launches} times for {VIEW_FRAMES} frames "
          f"and rendered {len(plain_calls)} frames on the plain path")
    check(np.array_equal(decode_png(parts[0]), refs[VIEW_FRAMES]),
          "the first /stream part (a PNG) equals the orbit's next frame bit for bit")
    check(stats["frame"] >= VIEW_FRAMES + STREAM_PARTS and stats["render_ms"] > 0,
          f"/stats after the stream: {stats}")
    out.update(render_ms=render_ms, fetch_ms=fetch_ms, stream_fps=stream_fps, stats=stats,
               png_bytes=len(encode_png(frames[0], viewer.PNG_LEVEL)))
    for level in sorted({viewer.PNG_LEVEL, 6}):
        ms = []
        for _ in range(3):
            t0 = time.perf_counter()
            encode_png(frames[0], level)
            ms.append((time.perf_counter() - t0) * 1e3)
        out[f"encode_ms_level{level}"] = ms
    t0 = time.perf_counter()
    decode_png(encode_png(frames[0], viewer.PNG_LEVEL))
    out["decode_ms"] = (time.perf_counter() - t0) * 1e3
    # The parts of a viewer frame's render_ms: the render alone, and the
    # copy of the quantised frame to the host alone.
    with torch.no_grad():
        out["render_alone_ms"] = [host_ms(lambda: marcher.render(camera=viewer.view(0)))[1]
                                  for _ in range(3)]
        u8 = quantize_tensor(frame0)
        out["uint8_copy_ms"] = [host_ms(lambda: u8.cpu())[1] for _ in range(3)]

    # The CLI: an orbit of three PNG frames and one TGA frame.
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        rk.LAUNCHES = 0
        rcs = [torch_view.main(["--orbit", "3", "--size", f"{WIDTH}x{HEIGHT}",
                                "--out", f"{d}/orbit.png"]),
               torch_view.main(["--size", f"{WIDTH}x{HEIGHT}", "--out", f"{d}/frame.tga"])]
        cli_launches = rk.LAUNCHES
        names = sorted(os.listdir(d))
        orbit = [decode_png(pathlib.Path(d, f"orbit-{i:03d}.png").read_bytes())
                 for i in range(3) if f"orbit-{i:03d}.png" in names]
        with torch.no_grad():
            want_tga = quantize(st.render(hero, WIDTH, HEIGHT,
                                          camera_position=(-2, 2, 4)).cpu().numpy())
            want_orbit = quantize_tensor(marcher.render(camera=torch_view.orbit_view(
                5.0, 2.0 * np.pi * 1 / 3, marcher.device))).cpu().numpy()
        tga = np.round(read_tga(f"{d}/frame.tga") * 255).astype(np.uint8) \
            if "frame.tga" in names else None
    check(rcs == [0, 0] and names == ["frame.tga", "orbit-000.png", "orbit-001.png",
                                      "orbit-002.png"]
          and all(o.shape == (HEIGHT, WIDTH, 3) for o in orbit)
          and np.array_equal(orbit[1], want_orbit) and np.array_equal(tga, want_tga)
          and cli_launches == 4,
          f"torch_view.main --orbit 3 and a .tga --out at {WIDTH}x{HEIGHT}: {names}, frames equal "
          f"RayMarcher.render's quantised, {cli_launches} launches")
    check(build.BUILDS == builds, f"the viewer built nothing ({build.BUILDS - builds} nvcc runs)")
    out["launches"] = launches
    out["cli_launches"] = cli_launches
    print(f"view {WIDTH}x{HEIGHT}: render (+ quantise + uint8 copy) ms "
          f"{[round(x, 3) for x in render_ms]}, a /frame.png fetched in "
          f"{[round(x, 1) for x in fetch_ms]} ms; PNG encode ms "
          + ", ".join(f"level {k[-1]} {[round(x, 1) for x in v]}" for k, v in out.items()
                      if k.startswith("encode_ms_level"))
          + f"; decode {out['decode_ms']:.1f} ms; the render alone "
          f"{[round(x, 3) for x in out['render_alone_ms']]} ms, the 6.2 MB uint8 copy alone "
          f"{[round(x, 3) for x in out['uint8_copy_ms']]} ms; stream {stream_fps:.2f} frames/s "
          f"(paced to "
          f"{torch_view.LiveViewer.MAX_STREAM_FPS:g}); on {smi}")
    return out


def phase_scaling(smi: str, fixed_ops: float) -> dict:
    """Phase 21: tools/torch_scaling.py at 1920x1080x40 over 1, 2 and 4 ranks
    on this card (one launch of 4 ranks in a gloo group). ``fixed_ops``: the
    "work:" lines' fixed work of the image forward on the whole frame."""
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.sdf.compile import compile_scene

    sys.path.insert(0, str(ROOT / "tools"))
    import torch_scaling

    # The library the ranks load: built here (phases 1-8 did), so no rank runs nvcc.
    build.load(compile_scene(scenes.sphere_repeat_scene()))
    with tempfile.TemporaryDirectory() as d:
        path = pathlib.Path(d, "scaling.json")
        try:
            rc = torch_scaling.main(["--process-group", "gloo",
                                     "--devices", *(str(n) for n in SCALING_DEVICES),
                                     "--width", str(WIDTH), "--height", str(HEIGHT),
                                     "--iters", "40", "--timeout", "300", "--out", str(path)])
        except RuntimeError as e:
            print(str(e)[-8000:], file=sys.stderr)
            check(False, "tools/torch_scaling.py ran its ranks on the card")
            return {}
        out = json.loads(path.read_text())
    points = out["points"]
    n_ranks = max(SCALING_DEVICES)
    check(rc == 0 and [p["devices"] for p in points] == list(SCALING_DEVICES)
          and all(p["frame_equal_to_one_rank"] for p in points)
          and len({p["frame_sha256"] for p in points}) == 1,
          f"torch_scaling: the {WIDTH}x{HEIGHT} frames at {SCALING_DEVICES} ranks equal one "
          f"rank's bit for bit (sha256 {points[0]['frame_sha256'][:16]}...)")
    check(all(p["launches_per_frame"] == [1.0] * p["devices"] for p in points)
          and out["render_backend"] == "kernel" and out["nvcc_builds"] == [0] * n_ranks
          and out["process_group"] == "gloo" and out["num_processes"] == n_ranks,
          f"torch_scaling: {n_ranks} ranks in a {out['process_group']} group, one image-forward "
          f"launch per rank and frame ({[p['launches_per_frame'] for p in points]}), nvcc runs "
          f"on the ranks {out['nvcc_builds']}")
    check(points[0]["per_device_operations"] == fixed_ops
          and all(p["work_partition_efficiency_pct"] == 100.0 for p in points),
          f"torch_scaling's work at one rank is the work: lines' fixed work ({fixed_ops:.6g}), "
          f"split evenly at every rank count")
    for p in points:
        print(f"scaling {p['devices']} rank(s) {WIDTH}x{HEIGHT}x40: min {p['seconds'] * 1e3:.3f} "
              f"ms {[round(x, 3) for x in p['ms']]}, {p['mrays_per_s']:.1f} Mrays/s, walltime "
              f"efficiency {p['walltime_efficiency_pct']:.2f}%, band efficiency "
              f"{p['band_efficiency_pct']:.2f}%, band ms per rank "
              f"{[round(x, 4) for x in p['band_ms']]}, shared card {p['shared_device']}; on {smi}")
    return out


BENCH_SECTIONS = ("render", "roofline", "occupancy", "fused_drift", "4k", "voxels", "mesh",
                  "mesh_512", "grad", "icp", "scaling")
BENCH_TIMEOUT = 560  # bench.py's time limit


def checkout_files() -> dict:
    """{path: (size, mtime)} of the checkout's files, the kernels' builds,
    Python's caches and ``chiprun_out/`` (git-ignored, where a remote run's
    own log may be growing) aside."""
    skip = (ROOT / "sdfkit_tpu_torch" / "_build", ROOT / "chiprun_out")
    out = {}
    for path in ROOT.rglob("*"):
        if path.is_file() and "__pycache__" not in path.parts and not any(
                path.is_relative_to(d) for d in skip):
            stat = path.stat()
            out[str(path.relative_to(ROOT))] = (stat.st_size, stat.st_mtime_ns)
    return out


def phase_bench() -> dict:
    """Phase 22: ``python3 bench_torch.py`` in a subprocess, after every
    kernel was built here (it runs no nvcc): its exit code, its section
    lines, its headline (``correct``, the card), and that it wrote nothing
    in the checkout."""
    torch.cuda.empty_cache()
    before = checkout_files()
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, str(ROOT / "bench_torch.py")], capture_output=True,
                              text=True, timeout=BENCH_TIMEOUT, cwd=ROOT)
    except subprocess.TimeoutExpired:
        check(False, f"bench_torch.py ended within {BENCH_TIMEOUT} s")
        return {}
    seconds = time.perf_counter() - t0
    lines = []
    for text in proc.stdout.splitlines():
        try:
            lines.append(json.loads(text))
        except json.JSONDecodeError:
            pass
    if proc.returncode != 0:
        print(proc.stderr[-8000:], file=sys.stderr)
    head = lines[-1] if lines else {}
    sections = {ln["section"]: ln for ln in lines[:-1] if "section" in ln}
    device = torch.cuda.get_device_name(0)
    print(f"bench_torch headline: {json.dumps(head)}")
    check(proc.returncode == 0 and seconds < BENCH_TIMEOUT,
          f"bench_torch.py exited {proc.returncode} in {seconds:.1f} s (limit {BENCH_TIMEOUT} s)")
    check(set(head) == {"metric", "value", "unit", "vs_baseline", "extra"}
          and head["extra"].get("correct") is True and len(json.dumps(head)) < 2000,
          f"bench_torch.py's headline parses, {len(json.dumps(head))} characters, correct "
          f"{head.get('extra', {}).get('correct')}")
    check(list(sections) == list(BENCH_SECTIONS)
          and not any("error" in ln for ln in sections.values()),
          f"bench_torch.py printed its sections in order: {list(sections)}")
    check(head.get("extra", {}).get("device") == device
          and all(ln["device"] == device for ln in sections.values()),
          f"bench_torch.py's lines name this card ({device})")
    render = sections.get("render", {}).get("extra", {})
    check(render.get("build_s", {}).get("nvcc_runs") == 0,
          f"bench_torch.py ran no nvcc for its first frame: {render.get('build_s')}")
    after = checkout_files()
    changed = sorted(k for k in before.keys() | after.keys() if before.get(k) != after.get(k))
    check(not changed, f"bench_torch.py wrote nothing in the checkout (changed: {changed[:10]})")
    return {"seconds": seconds, "headline": head}


GRID_STEPS = 4  # phase 24's fit steps
GRID_SUBSET = 16_384  # pixels of the 1080p frame whose cotangent phase 24 holds to the plain path


def build_union_grid() -> int:
    """``chip_smoke.py --build-union-grid``: build the six libraries of the
    200-sphere union in parallel (one nvcc each, all started together) and
    print one JSON line per library: its nvcc seconds, registers and local
    memory (the kernels' and the large tier's adjoints'). Phase 24 starts it
    in a process of its own at the start of the run, so that the builds go on
    while phases 1-23 run and their build counts see none of them; it then
    loads what this process built, with no nvcc of its own."""
    import concurrent.futures

    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.sdf.compile import compile_scene

    # The lowest priority, for this process and its nvcc children: phases
    # 1-23 run beside the builds, and their host clocks should see as little
    # of them as the host's cores allow.
    os.nice(19)
    prog = compile_scene(scenes.union_grid_scene(device="cpu"))

    def one(family):
        t0 = time.perf_counter()
        lib = build.load_family(prog, family)
        return {"family": family, "build_s": lib.build_seconds,
                "wall_s": time.perf_counter() - t0, "registers": lib.registers,
                "local_memory": lib.local_memory, "library": lib.path.name}

    with concurrent.futures.ThreadPoolExecutor(len(build.FAMILIES)) as pool:
        for line in pool.map(one, build.FAMILIES):
            print(json.dumps(line), flush=True)
    return 0


def phase_union_grid(st, smi: str, builder: subprocess.Popen) -> dict:
    """Phase 24: the fitting-sized scene, ``scenes.union_grid_scene`` (200
    spheres, 1,400 parameter slots: the backward's large tier) at
    1920x1080x40 from the default camera, through ``RayMarcher``, ``.sum()
    .backward()`` and ``fit``: the forward against the plain path, the
    backward against autograd of the plain path (every leaf and the view on a
    small frame; at 1080p on a seeded subset of the frame's pixels, the
    others' cotangent zero), two launches bit for bit (the large tier sums in
    a fixed order), ``fit`` of the 600 colour scalars, the store-fed and
    ray-batch forms once, every library's build and registers, and the
    kernels' times against their bounds."""
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build, work
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
    from sdfkit_tpu_torch.render.raymarch import render_rays, settled_steps
    from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params, operation_counts
    from sdfkit_tpu_torch.utils.camera import camera_rays

    t_wait = time.perf_counter()
    out, err = builder.communicate()
    waited = time.perf_counter() - t_wait
    built = {}
    for text in out.splitlines():
        if text.startswith("{"):
            line = json.loads(text)
            built[line["family"]] = line
    check(builder.returncode == 0 and set(built) == set(build.FAMILIES)
          and all(b["build_s"] is not None and b["build_s"] < 900 for b in built.values()),
          f"the six libraries of the 200-sphere scene built from the checkout's sources, each "
          f"within nvcc's 900 s (waited {waited:.1f} s for them): "
          f"{ {f: b['build_s'] for f, b in built.items()} } {err[-2000:] if builder.returncode else ''}")
    for family, b in built.items():
        print(f"build: union grid {family}: nvcc {b['build_s']} s, registers {b['registers']}, "
              f"local memory {b['local_memory']}")

    W, H = WIDTH, HEIGHT
    grid = scenes.union_grid_scene()
    prog = compile_scene(grid)
    counts = operation_counts(prog)
    v = st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = st.RenderConfig(W, H)
    builds = build.BUILDS
    libs = {f: build.load_family(prog, f) for f in build.FAMILIES}
    check(build.BUILDS == builds and prog.large and prog.n_params == 1400,
          f"phase 24 loaded the builder's libraries with no nvcc of its own (builds "
          f"{builds} -> {build.BUILDS}); the scene has {prog.n_params} slots and takes the large "
          f"tier: {prog.large}")
    resident = {f: [lib.resident(1), lib.resident(0)] for f, lib in libs.items()}

    # -- the forward: RayMarcher under 'auto', against the plain path -------
    marcher = st.RayMarcher(W, H, grid, view=v)
    torch.cuda.synchronize()
    rk.LAUNCHES = 0
    with torch.no_grad():
        frame = marcher.render()
        torch.cuda.synchronize()
        fwd_launches = rk.LAUNCHES
        depth = marcher.render_depth()
    hits = int((depth <= cfg.far).sum())
    plain = st.RayMarcher(W, H, grid, view=v, backend="torch")
    with torch.no_grad():
        plain_frame, plain_ms = host_ms(plain.render)
    ok, frame_stats = distributional(frame.cpu().numpy(), plain_frame.cpu().numpy())
    check(marcher.backend == "kernel" and fwd_launches == 1 and ok,
          f"the 200-sphere frame at {W}x{H}x40 through RayMarcher (backend {marcher.backend}, "
          f"LAUNCHES {fwd_launches}) against the plain path {frame_stats}; {hits} of {W * H} "
          f"pixels hit ({hits / (W * H):.4f})")

    # -- the backward: small frame, every leaf and the view -----------------
    def grads(w, h, backend, depth_mode, cot=None):
        for q in st.leaves(grid):
            q.grad = None
        vv = v.clone().requires_grad_()
        m = st.RayMarcher(w, h, grid, view=vv, backend=backend)
        if depth_mode:
            d = m.render_depth()
            loss = (torch.where(d < 50.0, d, torch.zeros_like(d)) ** 2).sum()
        elif cot is None:
            loss = (m.render() ** 2).sum()
        else:
            loss = (m.render() * cot).sum()
        loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad).reshape(-1)
                          for q in st.leaves(grid)])
        return flat.cpu().numpy(), vv.grad.cpu().numpy()

    def shares(got, ref):
        return {"leaf_err_of_largest": float(np.abs(got[0] - ref[0]).max()
                                             / max(np.abs(ref[0]).max(), 1e-30)),
                "view_err_of_largest": float(np.abs(got[1] - ref[1]).max()
                                             / max(np.abs(ref[1]).max(), 1e-30))}

    def close(got, ref, scale):
        """C.3: the JAX package's rtol (leaves 2e-3, view 5e-2) plus ``scale``
        of the largest reference entry."""
        (leaf, vw), (rleaf, rvw) = got, ref
        return (bool(np.isfinite(leaf).all() and np.isfinite(vw).all())
                and np.allclose(leaf, rleaf, rtol=2e-3, atol=1e-5 + scale * np.abs(rleaf).max())
                and np.allclose(vw, rvw, rtol=5e-2, atol=1e-3 + scale * np.abs(rvw).max()))

    small = {}
    for depth_mode in (False, True):
        rk.BWD_LAUNCHES = 0
        got = grads(64, 36, "kernel", depth_mode)
        launched = rk.BWD_LAUNCHES
        ref = grads(64, 36, "torch", depth_mode)
        scale = 2e-3 if depth_mode else 1e-2
        small["depth" if depth_mode else "rgb"] = stats = shares(got, ref)
        check(launched == 1 and close(got, ref, scale),
              f"the 200-sphere {'depth' if depth_mode else 'rgb'} gradient at 64x36 through the "
              f"kernels (BWD_LAUNCHES {launched}) against autograd of the plain path, every leaf "
              f"and the view (C.3: + {scale} of the largest entry) {stats}")

    # -- at 1080p: the kernels' gradient of the whole frame, its cotangent on
    #    a seeded subset of pixels, against autograd of the plain path on the
    #    same pixels' rays (the plain path's tape of the whole frame would
    #    not fit on the card: 40 steps of 2,199 operations a pixel) --------
    gen = torch.Generator(device="cuda").manual_seed(24)
    pick = torch.randperm(W * H, device="cuda", generator=gen)[:GRID_SUBSET]
    cot = torch.zeros((W * H, 3), device="cuda")
    cot[pick] = torch.rand((GRID_SUBSET, 3), device="cuda", generator=gen)
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    got = grads(W, H, "kernel", False, cot.view(H, W, 3))
    full_launches = (rk.LAUNCHES, rk.BWD_LAUNCHES)
    for q in st.leaves(grid):
        q.grad = None
    vv = v.clone().requires_grad_()
    ro, rd = camera_rays(W, H, vv, cfg.vfov_degrees, cfg.near, cfg.far)
    sub = [c.reshape(-1)[pick] for c in (ro.x.expand_as(rd.x), ro.y.expand_as(rd.y),
                                          ro.z.expand_as(rd.z), rd.x, rd.y, rd.z)]
    rgb = render_rays(grid, st.V3(*sub[:3]), st.V3(*sub[3:]), cfg)
    (rgb * cot[pick]).sum().backward()
    torch.cuda.synchronize()
    ref = (torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad).reshape(-1)
                      for q in st.leaves(grid)]).cpu().numpy(), vv.grad.cpu().numpy())
    full_stats = shares(got, ref)
    subset_plain_rgb = rgb.detach().cpu().numpy()
    check(full_launches == (1, 1) and close(got, ref, 5e-2),
          f"the 200-sphere gradient at {W}x{H}x40 through RayMarcher (LAUNCHES, BWD_LAUNCHES = "
          f"{full_launches}), its cotangent on {GRID_SUBSET} seeded pixels, against autograd of "
          f"the plain path on those pixels' rays, every leaf and the view (C.3 at full size: "
          f"+ 5e-2 of the largest entry) {full_stats}")
    del rgb, sub, ro, rd, ref

    # -- determinism: two launches of the large tier, bit for bit ------------
    params = flat_params(grid).detach().contiguous()
    v19 = rk.view19(v, cfg)
    full_cot = torch.rand((W * H, 3), device="cuda", generator=gen)
    with torch.no_grad():
        first = rk.launch_bwd(libs["bwd"], params, v19, cfg, True, full_cot)
        second = rk.launch_bwd(libs["bwd"], params, v19, cfg, True, full_cot)
    torch.cuda.synchronize()
    check(bool(torch.equal(first, second)) and bool(torch.isfinite(first).all()),
          "two launches of the large tier's image backward at 1080p give bit-identical, finite "
          "gradients (each warp sums its lanes with a fixed tree into a row of its own)")

    # -- fit of the 600 colour scalars toward another colour table ----------
    colours = st.leaves(grid)[1::3]
    check(len(colours) == 200 and all(c.shape == (3,) for c in colours),
          "the scene's colour leaves are every third leaf (radius, colour, offset)")
    target_colours = np.random.default_rng(1).uniform(0.2, 1.0, (200, 3)).astype(np.float32)
    saved = [c.detach().clone() for c in colours]
    with torch.no_grad():
        for c, t in zip(colours, target_colours):
            c.copy_(torch.from_numpy(t))
        target = st.RayMarcher(W, H, grid, view=v).render().clone()
        for c, s_ in zip(colours, saved):
            c.copy_(s_)
    torch.cuda.synchronize()
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    t0 = time.perf_counter()
    fitted = st.fit(grid, target, steps=GRID_STEPS, view=v,
                    optimizer=lambda leaves: torch.optim.Adam(leaves[1::3], lr=5e-2))
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    fit_launches = (rk.LAUNCHES, rk.BWD_LAUNCHES)
    check(fit_launches == (GRID_STEPS, GRID_STEPS) and all(np.isfinite(fitted.losses))
          and fitted.losses[-1] < fitted.losses[0],
          f"fit of the 600 colour scalars at {W}x{H}x40: {GRID_STEPS} steps through the kernels "
          f"(LAUNCHES, BWD_LAUNCHES = {fit_launches}) in {fit_s:.3f} s, losses {fitted.losses}")

    # -- the store-fed and ray-batch forms, once ------------------------------
    rk.STORE_LAUNCHES = rk.STORE_BWD_LAUNCHES = 0
    with torch.no_grad():
        store_frame, store = rk.launch(libs["fwd_store"], params, v19, cfg, True,
                                       want_store=True)
        fed = rk.launch_bwd(libs["bwd_store"], params, v19, cfg, True, full_cot, store=store)
    torch.cuda.synchronize()
    store_launches = (rk.STORE_LAUNCHES, rk.STORE_BWD_LAUNCHES)
    ok, store_stats = distributional(store_frame.view(H, W, 3).cpu().numpy(),
                                     plain_frame.cpu().numpy())
    check(store_launches[0] == 1 and ok,
          f"the forward with store of the 200-sphere scene at {W}x{H}x40 (STORE_LAUNCHES "
          f"{store_launches[0]}) against the plain path {store_stats}")
    del store_frame, plain_frame
    fed_share = float((fed - first).abs().max() / first.abs().max())
    check(store_launches[1] == 1 and fed_share <= 1e-5,
          f"the store-fed backward of the 200-sphere scene at 1080p (STORE_BWD_LAUNCHES "
          f"{store_launches[1]}) against the replay: {fed_share:.3g} of the largest entry (the "
          f"same depths; at most 1e-5)")
    steps = work.march_steps_needed(settled_steps(store), cfg.depth_iterations)
    del store
    ro, rd = camera_rays(W, H, v, cfg.vfov_degrees, cfg.near, cfg.far)
    rays = [c.contiguous().view(-1) for c in (ro.x.expand_as(rd.x), ro.y.expand_as(rd.y),
                                               ro.z.expand_as(rd.z), rd.x, rd.y, rd.z)]
    rk.RAYS_LAUNCHES = rk.RAYS_BWD_LAUNCHES = 0
    with torch.no_grad():
        ray_rgb, hit = rk.launch_rays(libs["rays_fwd"], params, rays, cfg, True, want_hit=True)
        g_rays_params, _ = rk.launch_rays_bwd(libs["rays_bwd"], params, rays, cfg, True,
                                              full_cot, hit=hit)
    torch.cuda.synchronize()
    rays_launches = (rk.RAYS_LAUNCHES, rk.RAYS_BWD_LAUNCHES)
    ray_hits = int(hit.sum())
    # The ray-batch forward against render_rays on the 1080p gradient check's
    # seeded subset of the camera rays (the same rays: camera_rays of a copy
    # of the view).
    ok, rays_fwd_stats = distributional(ray_rgb[pick].cpu().numpy(), subset_plain_rgb)
    check(rays_launches[0] == 1 and ok,
          f"the ray-batch forward of the 200-sphere scene on the frame's {W * H} camera rays "
          f"(RAYS_LAUNCHES {rays_launches[0]}), its colours of the {GRID_SUBSET} seeded rays "
          f"against render_rays on them {rays_fwd_stats}")
    del ray_rgb
    rays_share = float((g_rays_params - first[:prog.n_params]).abs().max()
                       / first[:prog.n_params].abs().max())
    check(rays_launches[1] == 1
          and bool(torch.isfinite(g_rays_params).all()) and abs(ray_hits - hits) <= 1e-3 * W * H,
          f"the ray-batch forms on the frame's {W * H} camera rays (RAYS_BWD_LAUNCHES "
          f"{rays_launches[1]}): {ray_hits} hit (the image "
          f"forward {hits}), the pullback finite; {rays_share:.3g} of the largest entry from the "
          f"image backward's (the two make their rays apart by an ulp, and a grazing ray's "
          f"gradient is ill conditioned, C.3)")
    # The ray-batch pullback against autograd of the plain path on a small
    # frame's camera rays, fed one cotangent.
    sro, srd = camera_rays(64, 36, v, cfg.vfov_degrees, cfg.near, cfg.far)
    scot = torch.rand((36, 64, 3), device="cuda", generator=gen)
    small_rays = {}
    for backend in ("kernel", "torch"):
        for q in st.leaves(grid):
            q.grad = None
        fn = rk.render_rays_kernel if backend == "kernel" else render_rays
        rk.RAYS_LAUNCHES = rk.RAYS_BWD_LAUNCHES = 0
        (fn(grid, sro, srd, st.RenderConfig(64, 36)) * scot).sum().backward()
        torch.cuda.synchronize()
        if backend == "kernel":
            small_rays_launches = (rk.RAYS_LAUNCHES, rk.RAYS_BWD_LAUNCHES)
        small_rays[backend] = (torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad)
                                          .reshape(-1) for q in st.leaves(grid)]).cpu().numpy(),
                               np.zeros(1))
    rays_small = shares(small_rays["kernel"], small_rays["torch"])["leaf_err_of_largest"]
    check(small_rays_launches == (1, 1) and close(small_rays["kernel"], small_rays["torch"], 1e-2),
          f"the ray-batch pullback of the 200-sphere scene at 64x36 (RAYS_LAUNCHES, "
          f"RAYS_BWD_LAUNCHES = {small_rays_launches}) against autograd of the "
          f"plain path, every leaf (C.3: + 1e-2 of the largest entry): {rays_small:.3g} of the "
          f"largest entry")

    # -- times with CUDA events, against their bounds -------------------------
    def events(fn, timed=5) -> float:
        fn()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(timed):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / timed

    with torch.no_grad():
        _, store = rk.launch(libs["fwd_store"], params, v19, cfg, True, want_store=True)
        times = {
            "fwd": events(lambda: rk.launch(libs["fwd"], params, v19, cfg, True)),
            "fwd_depth": events(lambda: rk.launch(libs["fwd"], params, v19, cfg, False)),
            "fwd_store": events(lambda: rk.launch(libs["fwd_store"], params, v19, cfg, True,
                                                  want_store=True)),
            "bwd": events(lambda: rk.launch_bwd(libs["bwd"], params, v19, cfg, True, full_cot),
                          3),
            "bwd_store": events(lambda: rk.launch_bwd(libs["bwd_store"], params, v19, cfg, True,
                                                      full_cot, store=store), 3),
            "rays_fwd": events(lambda: rk.launch_rays(libs["rays_fwd"], params, rays, cfg, True)),
            "rays_bwd": events(lambda: rk.launch_rays_bwd(libs["rays_bwd"], params, rays, cfg,
                                                          True, full_cot, hit=hit), 3),
        }
        del store
    costs = work.frame_work(prog, cfg.depth_iterations, W * H, hits, steps, ray_hits, steps)
    bounds = {"fwd": costs["fwd"].bound(), "fwd_store": costs["fwd_store"].bound(),
              "bwd": costs["bwd"].bound(),
              "bwd_store": costs["bwd_store"].bound(), "rays_fwd": costs["rays_fwd"].bound(),
              "rays_bwd": costs["rays_bwd"].bound()}
    fixed = {"fwd": costs["fwd_fixed"].bound()[0], "fwd_store": costs["fwd_store_fixed"].bound()[0],
             "rays_fwd": costs["rays_fwd_fixed"].bound()[0]}
    for k, ms in times.items():
        bound = (f", bound {bounds[k][0]:.4f} ms by {bounds[k][1]}" if k in bounds else "")
        print(f"timing: union grid {k} {ms:.4f} ms a launch at {W}x{H}x40{bound}"
              + (f" (fixed work {fixed[k]:.4f} ms)" if k in fixed else "") + f" on {smi}")
    torch.cuda.empty_cache()
    return {
        "scene": "union_grid_scene(200)", "parameter_slots": prog.n_params,
        "large_tier": prog.large, "operations": counts, "pixels": W * H, "hit_pixels": hits,
        "hit_share": hits / (W * H), "march_steps_needed": steps,
        "builds": {f: {k: b[k] for k in ("build_s", "registers", "local_memory")}
                   for f, b in built.items()},
        "resident_blocks_per_sm": resident, "waited_for_builds_s": waited,
        "frame_vs_plain": frame_stats, "plain_frame_ms": plain_ms,
        "store_frame_vs_plain": store_stats, "rays_subset_vs_plain": rays_fwd_stats,
        "grad_64x36": small, "grad_1080p_subset": full_stats, "store_vs_replay": fed_share,
        "rays_vs_image": rays_share, "rays_64x36_leaf_err_of_largest": rays_small,
        "fit_losses": fitted.losses, "fit_s": fit_s,
        "launches": {"fwd": fwd_launches, "grad_1080p": list(full_launches),
                     "fit": list(fit_launches), "store": list(store_launches),
                     "rays_1080p": list(rays_launches), "rays_64x36": list(small_rays_launches)},
        "ms": times, "bound_ms": {k: b[0] for k, b in bounds.items()},
        "bound_by": {k: b[1] for k, b in bounds.items()}, "bound_ms_fixed_work": fixed,
        "gpu": smi,
    }


CARDS_RANKS = 4  # phase 23's ranks: one per card, at most four
CARDS_TIMEOUT = 600.0
CARDS_SCALING = ((WIDTH, HEIGHT), (3840, 2160))
CARDS_SCALING_POINTS = (1, 2, 4)


def one_process_cards(st, order) -> dict:
    """Phase 23's first part, in this process (its current card stays
    ``cuda:0``): SphereRepeat at 1920x1080x40 from (-2, 2, 4), RGB and depth
    through ``RayMarcher``, and a gradient step (radius 0.55 against the
    frame at 0.5, the mean squared error, ``backward``) on each card of
    ``order``; every output held bit for bit to the first card's. The
    kernel libraries are each one build: a launch on another card uses that
    card's copy of their code and uniforms."""
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk

    ref = target = None
    cards = []
    for d in order:
        dev = torch.device("cuda", d)
        view = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), device=dev)
        before = (rk.LAUNCHES, rk.BWD_LAUNCHES)
        marcher = st.RayMarcher(WIDTH, HEIGHT, scenes.sphere_repeat_scene(dev), view=view)
        with torch.no_grad():
            rgb, depth = marcher.render(), marcher.render_depth()
        if target is None:
            target = rgb
        start = scenes.sphere_repeat_scene(dev)
        with torch.no_grad():
            st.leaves(start)[0].fill_(START_RADIUS)
        loss = ((st.RayMarcher(WIDTH, HEIGHT, start, view=view).render()
                 - target.to(dev)) ** 2).mean()
        loss.backward()
        torch.cuda.synchronize(dev)
        got = {"rgb": rgb.cpu().numpy(), "depth": depth.cpu().numpy(),
               "loss": np.float32(loss.item()),
               "grads": np.concatenate([p.grad.reshape(-1).cpu().numpy()
                                        for p in st.leaves(start)])}
        ref = got if ref is None else ref
        cards.append({
            "card": d, "outputs_on": [str(t.device) for t in (rgb, depth, loss)],
            "current_device": torch.cuda.current_device(),
            "launches": [rk.LAUNCHES - before[0], rk.BWD_LAUNCHES - before[1]],
            **{f"{k}_equal": bool(np.array_equal(got[k], ref[k])) for k in got},
            "rgb_mean": float(got["rgb"].mean()), "loss": float(got["loss"])})
    return {"order": list(order), "first": order[0], "cards": cards}


def cards_checks(reports: list[dict], size: str, vertices: dict, cards: int,
                 scaling: dict | None = None, one: dict | None = None) -> list[tuple[bool, str]]:
    """Phase 23's checks of the ranks' reports (``torch_distributed_demo``
    at ``size``), the scaling runs (``{"WxH": torch_scaling's JSON}``) and
    the one-process run: ``(ok, what)`` each."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_distributed_demo as demo

    n, cfg = len(reports), demo.SIZES[size]
    out = []
    failed = [what for r in reports for ok, what in r["checks"] if not ok]
    n_checks = sum(len(r["checks"]) for r in reports)
    out.append((not failed and n_checks > 0,
                f"{n} ranks over NCCL, a card each: {n_checks} checks passed on the ranks "
                f"(failed: {failed[:3]})"))
    devices = [r["device"] for r in reports]
    buses = [r.get("pci_bus_id") for r in reports]
    out.append(([r["rank"] for r in reports] == list(range(n))
                and all(r["backend"] == "nccl" and r["ranks"] == n for r in reports)
                and devices == [f"cuda:{r}" for r in range(n)]
                and None not in buses and len(set(buses)) == n,
                f"every rank in one NCCL group of {n} on a card of its own: {devices}, PCI "
                f"{buses}"))
    out.append((all(r["nvcc_builds"] == 0 for r in reports),
                f"no rank ran nvcc: {[r['nvcc_builds'] for r in reports]}"))
    launches = {k: [r["launches"][k] for r in reports] for k in reports[0]["launches"]}
    frame = f"k_render_sharded_{cfg['width']}x{cfg['height']}"
    steps = cfg["fit_steps"]
    fours = [k for k in ("render_sharded_depth_4k", "render_sharded_rgb_4k") if k in launches]
    out.append((launches[frame] == [[1, 0]] * n
                and launches["k_train_step_sharded"] == [[1, 1]] * n
                and launches["k_fit_mesh"] == [[steps, steps]] * n
                and all(launches[k] == [[1, 0]] * n for k in fours),
                f"one image-forward launch per rank and frame ({frame}, {fours}), one forward and "
                f"one backward per rank and step: {launches}"))
    got = [mesh_vertices(r, size) for r in reports]
    out.append((all(g == vertices for g in got),
                f"create_mesh_sharded's vertices on each rank {got}, expected {vertices}"))
    for res, pts in (scaling or {}).items():
        points = pts["points"]
        out.append((pts["process_group"] == "nccl"
                    and [p["devices"] for p in points] == [d for d in CARDS_SCALING_POINTS
                                                           if d <= n]
                    and all(p["frame_equal_to_one_rank"] and not p["shared_device"]
                            and p["launches_per_frame"] == [1.0] * p["devices"] for p in points)
                    and len({p["frame_sha256"] for p in points}) == 1
                    and pts["nvcc_builds"] == [0] * pts["num_processes"]
                    and len(set(pts["rank_devices"])) == pts["num_processes"],
                    f"torch_scaling {res} over NCCL at {[p['devices'] for p in points]} cards: "
                    f"frames equal one rank's, no card shared, one launch per rank and frame, "
                    f"no nvcc"))
    if one is not None:
        bad = [c for c in one["cards"]
               if not (c["rgb_equal"] and c["depth_equal"] and c["loss_equal"] and c["grads_equal"]
                       and c["outputs_on"] == [f"cuda:{c['card']}"] * 3
                       and c["current_device"] == one["first"] and c["launches"] == [3, 1])]
        out.append((not bad and [c["card"] for c in one["cards"]] == one["order"]
                    and set(one["order"]) == set(range(cards)),
                    f"one process, the cards in the order {one['order']}: RGB, depth, the loss "
                    f"and the gradients bit-identical to cuda:{one['first']}'s, each on its own "
                    f"card, three forward and one backward launch a card (differing: {bad})"))
    return out


def mesh_vertices(report: dict, size: str) -> dict:
    """{grid side: vertices} of the meshes a rank of ``torch_distributed_demo``
    at ``size`` made with ``create_mesh_sharded``."""
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_distributed_demo as demo

    out = {demo.SIZES[size]["grid"]: report["mesh_vertices"]}
    out.update({int(k.rsplit("_", 1)[1]): v for k, v in report.items()
                if k.startswith("mesh_vertices_")})
    return out


def _ms(t: dict) -> dict:
    """A timed path of a rank's report: min and every sample, beside one
    rank's; ``repeat`` calls a sample (ms per call)."""
    return {"min_ms": min(t["ranks_ms"]), "ms": t["ranks_ms"],
            "one_rank_min_ms": min(t["one_rank_ms"]) if t["one_rank_ms"] else None,
            "one_rank_ms": t["one_rank_ms"], "repeat": t.get("repeat", 1)}


def cards_line(reports: list[dict], size: str, scaling: dict, one: dict, smi: str, cards: int,
               seconds: float) -> dict:
    """The ``sharded_cards`` JSON line of phase 23."""
    times = reports[0]["times"]
    collectives = {k: _ms(t) for k, t in times.items() if k.startswith(("all_gather",
                                                                         "all_reduce"))}
    return {
        "ran": True, "cards": cards, "ranks": len(reports), "backend": reports[0]["backend"],
        "gpu": smi, "seconds": seconds,
        "devices": [{"rank": r["rank"], "device": r["device"], "pci_bus_id": r.get("pci_bus_id")}
                    for r in reports],
        "paths": {k: _ms(t) for k, t in times.items() if k not in collectives},
        "collectives": collectives,
        "launches_per_rank": {k: [r["launches"][k] for r in reports]
                              for k in reports[0]["launches"]},
        "mesh_vertices": mesh_vertices(reports[0], size),
        "errors": reports[0]["errors"],
        "scaling": {res: [{k: p[k] for k in ("devices", "seconds", "ms", "mrays_per_s",
                                              "walltime_efficiency_pct", "band_ms",
                                              "band_efficiency_pct", "shared_device")}
                          for p in out["points"]] for res, out in scaling.items()},
        "one_process": one,
    }


def cards_launches(line: dict, which: int) -> dict:
    """Phase 23's launches of the image forward (``which`` 0) or backward
    (1), summed over the ranks, by path; {} when the phase did not run."""
    if not line.get("ran"):
        return {}
    return {k: sum(r[which] for r in v) for k, v in line["launches_per_rank"].items()}


def nvlink_summary() -> str:
    """Each card's NVLink links and their rates, from ``nvidia-smi nvlink
    --status`` (its whole output where it lists none)."""
    text = sh(["nvidia-smi", "nvlink", "--status"])
    cards = []
    for line in text.splitlines():
        if line.startswith("GPU "):
            cards.append((line.split(":")[0], []))
        elif line.strip().startswith("Link ") and cards:
            cards[-1][1].append(line.split(":", 1)[1].strip())
    if not any(rates for _, rates in cards):
        return text
    return "; ".join(f"{card}: {len(rates)} links at {', '.join(sorted(set(rates)))}"
                     for card, rates in cards)


def phase_cards(st, smi: str) -> dict:
    """Phase 23: the sharded paths over NCCL with a card for each rank, on
    every card of the machine (up to four), after the same work in this one
    process on each card. On one card it prints why it did not run."""
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.sdf.compile import compile_scene

    cards = torch.cuda.device_count()
    if cards < 2:
        reason = (f"this machine has {cards} card; the sharded paths over NCCL need a card "
                  f"for each rank, at least two")
        print(f"phase 23 did not run: {reason}")
        return {"ran": False, "cards": cards, "reason": reason}
    sys.path.insert(0, str(ROOT / "tools"))
    import torch_distributed_demo as demo
    import torch_scaling

    links = nvlink_summary()
    print(f"cards: {sh(['nvidia-smi', '-L'])}\nlinks: {links}")
    t0 = time.perf_counter()
    n = min(CARDS_RANKS, cards)
    prog = compile_scene(scenes.sphere_repeat_scene())
    build.load(prog)  # the ranks load these libraries; none runs nvcc
    build.load_bwd(prog)
    one = one_process_cards(st, [0, cards - 1, 0, 1, *range(2, cards - 1)])
    reports = demo.launch(n, device="cuda", size="cards", backend="nccl", timeout=CARDS_TIMEOUT,
                          echo=True)
    scaling = {}
    with tempfile.TemporaryDirectory() as d:
        for w, h in CARDS_SCALING:
            path = pathlib.Path(d, f"scaling_{w}x{h}.json")
            rc = torch_scaling.main([
                "--process-group", "nccl", "--devices",
                *(str(k) for k in CARDS_SCALING_POINTS if k <= n), "--width", str(w), "--height",
                str(h), "--iters", "40", "--timeout", "300", "--out", str(path)])
            check(rc == 0, f"torch_scaling {w}x{h} over NCCL exited {rc}")
            scaling[f"{w}x{h}"] = json.loads(path.read_text())
    vertices = {g: JAX_MESH_VERTICES[g] for g in MESH_GRIDS}
    for ok, what in cards_checks(reports, "cards", vertices, cards, scaling, one):
        check(ok, what)
    line = cards_line(reports, "cards", scaling, one, smi, cards, time.perf_counter() - t0)
    line["links"] = links
    for name, t in line["paths"].items():
        print(f"cards {name}: {n} cards (nccl) min {t['min_ms']:.3f} ms "
              f"{[round(x, 3) for x in t['ms']]}; one rank min {t['one_rank_min_ms']} ms; on {smi}")
    for name, t in line["collectives"].items():
        print(f"cards {name}: {n} cards (nccl) min {t['min_ms']:.4f} ms "
              f"{[round(x, 4) for x in t['ms']]}; on {smi}")
    for res, points in line["scaling"].items():
        for p in points:
            print(f"cards scaling {res}x40 {p['devices']} card(s): min {p['seconds'] * 1e3:.3f} ms "
                  f"{[round(x, 3) for x in p['ms']]}, walltime efficiency "
                  f"{p['walltime_efficiency_pct']:.2f}%, band ms {p['band_ms']}, band "
                  f"efficiency {p['band_efficiency_pct']:.2f}%; on {smi}")
    return line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA GPU",
              file=sys.stderr)
        return 1
    if not GOLDENS.is_dir():
        print(f"chip_smoke: {GOLDENS} is missing; run from a checkout of the repository",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
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
    # Phase 24's six libraries build in a process of their own meanwhile.
    grid_builder = subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                     "--build-union-grid"], stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True, cwd=ROOT)
    CHILDREN.append(grid_builder)
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

    # -- 2b. a scene too large for the constant bank: a palette of 5,500 rows
    #        makes 16,506 parameter slots, whose libraries keep the uniforms
    #        in device memory (csrc/raymarch_uniforms.cuh). 'auto' takes the
    #        kernels through every entry point that renders, and each frame
    #        agrees with the plain path. The cells in view take rows from both
    #        ends of the palette (index 37 x + y mod 5,500).
    from sdfkit_tpu_torch.parallel import render_tiles_resumable
    from sdfkit_tpu_torch.render.raymarch import render_rays
    from sdfkit_tpu_torch.utils.camera import camera_rays

    table = np.random.default_rng(5).uniform(0.2, 1.0, (5500, 3)).astype(np.float32)
    big = st.sphere(0.4).repeat_indexed("xy", (1.125, 1.125), table,
                                        index_fn=lambda x, y, z: x * 37.0 + y)
    big_prog = compile_scene(big)
    bw, bh = 40, 24
    big_cfg = st.RenderConfig(bw, bh)
    torch.cuda.synchronize()
    rk.LAUNCHES = rk.RAYS_LAUNCHES = 0
    with torch.no_grad(), tempfile.TemporaryDirectory() as tiles_dir:
        big_marcher = st.RayMarcher(bw, bh, big, view=view())
        big_rgb = big_marcher.render()
        big_depth = big_marcher.render_depth()
        big_render = st.render(big, bw, bh, camera_position=(0.0, 0.0, 5.0))
        big_tiles, _ = render_tiles_resumable(big, bw, bh, tiles_dir, view=view(), tile_rows=8)
        ro, rd = camera_rays(bw, bh, view(), big_cfg.vfov_degrees, big_cfg.near, big_cfg.far)
        big_rays = rk.render_rays_kernel(big, ro, rd, big_cfg)
        torch.cuda.synchronize()
        big_launches = (rk.LAUNCHES, rk.RAYS_LAUNCHES)
        big_plain = st.RayMarcher(bw, bh, big, view=view(), backend="torch")
        plain_rgb, plain_depth = big_plain.render(), big_plain.render_depth()
        plain_rays = render_rays(big, ro, rd, big_cfg)
    torch.cuda.synchronize()
    check(big_prog.n_params + 19 > 64 * 1024 // 4 and big_marcher.backend == "kernel"
          and big_launches[0] >= 3 and big_launches[1] == 1,
          f"a scene of {big_prog.n_params} parameter slots (past the constant bank) renders "
          f"through the kernels under backend='auto' (LAUNCHES, RAYS_LAUNCHES = {big_launches})")
    ok, stats = depth_close(big_depth.cpu().numpy(), plain_depth.cpu().numpy())
    check(ok, f"the {big_prog.n_params}-slot scene, depth {bw}x{bh}: kernel vs plain {stats}")
    for what, got, ref in (("RayMarcher", big_rgb, plain_rgb), ("render", big_render, plain_rgb),
                           ("render_tiles_resumable", torch.from_numpy(big_tiles), plain_rgb),
                           ("render_rays_kernel", big_rays, plain_rays)):
        ok, stats = rgb_close(got.cpu().numpy(), ref.cpu().numpy())
        check(ok, f"the {big_prog.n_params}-slot scene, rgb {bw}x{bh} through {what}: kernel vs "
                  f"plain {stats}")
    del big_marcher, big_plain, big_rgb, big_depth, big_render, big_tiles, big_rays
    del plain_rgb, plain_depth, plain_rays, ro, rd

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
    def time_frames(m, warmup=WARMUP, timed=TIMED) -> float:
        with torch.no_grad():
            for _ in range(warmup):
                m.render()
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(timed):
                m.render()
            stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / timed

    # The plain path's frames take ~80 ms each: fewer of them keep the run short.
    rounds = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        rounds[which].append(time_frames(plain, 1, 3) if which == "plain" else time_frames(marcher))
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
    bwd_refs = {}  # the plain path's gradients, held against the store-fed backward in phase 12
    for name, expr, w, h in bwd_cases:
        for depth in (False, True):
            v = view((-2.0, 2.0, 4.0))
            bwd_refs[(name, w, h, depth)] = ref = grads(expr, w, h, v, "torch", depth)
            ok, stats = grads_close(grads(expr, w, h, v, "kernel", depth), ref, depth)
            check(ok, f"{name} {'depth' if depth else 'rgb'} {w}x{h} backward kernel vs "
                      f"autograd of the plain path, every leaf and the view {stats}")
            if name == "union":
                bwd_err = max(bwd_err, stats["max_abs_err"])
    # The 16,506-slot scene of phase 2b differentiates and fits through the
    # kernels too: its adjoint adds a large palette's cotangent to a run-time
    # row (sdf/compile.py PALETTE_UNROLLED_ROWS).
    builds = build.BUILDS
    t0 = time.perf_counter()
    big_ref = grads(big, bw, bh, view(), "torch", False)
    ok, stats = grads_close(grads(big, bw, bh, view(), "kernel", False), big_ref, False)
    big_bwd_s = time.perf_counter() - t0
    check(ok and build.BUILDS == builds + 1,
          f"the {big_prog.n_params}-slot scene, rgb {bw}x{bh}: backward kernel vs autograd of "
          f"the plain path, every leaf and the view {stats}; its backward library built in "
          f"{big_bwd_s:.1f} s with the two gradients")
    torch.cuda.synchronize()
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    big_fit = st.fit(big, torch.full((bh, bw, 3), 0.5), steps=2, view=view())
    torch.cuda.synchronize()
    big_fit_launches = (rk.LAUNCHES, rk.BWD_LAUNCHES)
    check(big_fit_launches == (2, 2) and all(np.isfinite(big_fit.losses)),
          f"fit of the {big_prog.n_params}-slot scene under backend='auto': 2 steps through the "
          f"kernels (LAUNCHES, BWD_LAUNCHES = {big_fit_launches}), losses {big_fit.losses}")
    del big, big_fit, big_ref

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

    def device_events(fn, warmup=WARMUP, timed=TIMED) -> float:
        """Device ms per call of ``fn``, the timed calls queued behind a sleep
        on the stream: a launch on the mostly-sky frame is shorter than the
        host's work to make it, and ``events`` would time the host's pace."""
        for _ in range(warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(timed):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        check(host_ms < sleep_ms, f"the host queued {timed} launches in {host_ms:.3f} ms, inside "
                                  f"the {sleep_ms:.3f} ms sleep ahead of them")
        return start.elapsed_time(stop) / timed

    def time_sleep() -> float:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    time_sleep()
    sleep_ms = time_sleep()

    cfg = marcher.config
    with torch.no_grad():
        params = torch.cat([q.reshape(-1) for q in st.leaves(hero)]).contiguous()
        v19 = rk.view19(hero_view, cfg)
        cot = (2.0 / target.numel()) * (marcher.render() - target).reshape(-1, 3).contiguous()
    bwd_launch_ms = events(lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot))
    # The same two launches on a frame that is mostly sky: one sphere of
    # radius 0.5 under the same camera. A sky pixel replays its march and
    # stops after the colour step, so a backward must not be paid for there.
    lone = st.sphere(0.5)
    lone_prog = compile_scene(lone)
    with torch.no_grad():
        lone_params = torch.cat([q.reshape(-1) for q in st.leaves(lone)]).contiguous()
        lone_fwd, lone_bwd = build.load(lone_prog), build.load_bwd(lone_prog)
        lone_frame = rk.launch(lone_fwd, lone_params, v19, cfg, True)
        lone_hits = int((rk.launch(lone_fwd, lone_params, v19, cfg, False) <= cfg.far).sum())
        lone_cot = (2.0 / lone_frame.numel()) * (lone_frame - 0.5)
        sky_fwd_ms = device_events(lambda: rk.launch(lone_fwd, lone_params, v19, cfg, True))
        sky_bwd_ms = events(lambda: rk.launch_bwd(lone_bwd, lone_params, v19, cfg, True, lone_cot))
        lone_grad = rk.launch_bwd(lone_bwd, lone_params, v19, cfg, True, lone_cot)
    check(bool(torch.isfinite(lone_grad).all()) and float(lone_grad.abs().max()) > 0
          and 0 < lone_hits < 0.1 * WIDTH * HEIGHT,
          f"the mostly-sky frame (one sphere, {lone_hits} of {WIDTH * HEIGHT} pixels hit) has a "
          f"finite gradient")
    del lone_frame, lone_cot, lone_grad
    # A library's uniforms are one buffer in constant memory: two streams that
    # render two parameter sets through it must not see each other's.
    with torch.no_grad():
        other_params = params * 0.9
        alone = [rk.launch(lib, p, v19, cfg, True) for p in (params, other_params)]
        torch.cuda.synchronize()
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        mixed = []
        for _ in range(4):
            for stream, p in zip(streams, (params, other_params)):
                with torch.cuda.stream(stream):
                    mixed.append(rk.launch(lib, p, v19, cfg, True))
        torch.cuda.synchronize()
    check(not torch.equal(alone[0], alone[1])
          and all(torch.equal(f, alone[i % 2]) for i, f in enumerate(mixed)),
          "eight frames of two parameter sets launched in turns on two streams through one "
          "library are each bit-identical to the frame rendered alone")
    del alone, mixed, other_params

    def grad_step(w, h, backend, tgt):
        m = st.RayMarcher(w, h, hero, view=hero_view, backend=backend)

        def run():
            for q in st.leaves(hero):
                q.grad = None
            torch.mean((m.render() - tgt) ** 2).backward()
        return run

    def backward_only(w, h, backend, tgt, warmup=WARMUP, timed=TIMED) -> float:
        """The backward pass alone: the loss is built outside the events."""
        m = st.RayMarcher(w, h, hero, view=hero_view, backend=backend)
        total = 0.0
        for i in range(warmup + timed):
            loss = torch.mean((m.render() - tgt) ** 2)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            loss.backward()
            stop.record()
            torch.cuda.synchronize()
            if i >= warmup:
                total += start.elapsed_time(stop)
        return total / timed

    pw, ph = plain_size if plain_size is not None else (480, 270)
    grad_rounds = {"plain": [], "kernel": [], "kernel_full": []}
    bwd_rounds = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        backend = "torch" if which == "plain" else "kernel"
        # A plain step at full size takes ~0.3 s: one warm-up and three timed.
        turns = (1, 3) if which == "plain" else (2, 5)
        grad_rounds[which].append(events(grad_step(pw, ph, backend, small_target), *turns))
        bwd_rounds[which].append(backward_only(pw, ph, backend, small_target,
                                               *((1, 3) if which == "plain" else (WARMUP, TIMED))))
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
    print(f"timing the mostly-sky frame (one sphere of radius 0.5, {lone_hits} of "
          f"{WIDTH * HEIGHT} pixels hit), launches alone: forward {sky_fwd_ms:.4f} ms, backward "
          f"{sky_bwd_ms:.4f} ms at {WIDTH}x{HEIGHT}x40 on {smi}")
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
    # -- 10. the ray-batch forward kernel ------------------------------------
    from sdfkit_tpu_torch.grid import voxelize
    from sdfkit_tpu_torch.render.raymarch import (march_history, render_depth_rays,
                                                  settled_steps, warp_march_steps)
    from sdfkit_tpu_torch.sdf.compile import flat_params
    from sdfkit_tpu_torch.utils.camera import inv_view_proj

    def v3(a, requires_grad=False):
        """An (..., 3) numpy array as a V3 of tensors on the card."""
        return st.V3(*(torch.from_numpy(np.ascontiguousarray(a[..., k])).cuda()
                       .requires_grad_(requires_grad) for k in range(3)))

    def scattered_rays(n, seed):
        """Seeded rays that are no camera's: origins around (0, 0, 5), each
        aimed at its own point of the z=0 plane."""
        rng = np.random.default_rng(seed)
        ro = (np.array([0.0, 0.0, 5.0]) + 0.3 * rng.standard_normal((n, 3))).astype(np.float32)
        target = np.concatenate([rng.uniform(-1.5, 1.5, (n, 2)), np.zeros((n, 1))], axis=-1)
        rd = target - ro
        return ro, (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)

    def hit_depth_close(a, b, far) -> tuple[bool, dict]:
        """Depth of two marches of the same kernel code on rays made by two
        programs (torch and the kernel round ray generation differently):
        rtol 1e-4 where both hit, but for grazing rays, where an ulp of
        direction compounds over the steps or decides between surface and
        sky; at most 0.5% of the frame may be those (the share the
        distributional contract allows beyond 1e-2)."""
        both_hit = (a <= far) & (b <= far)
        rel = np.abs(a - b)[both_hit] / np.abs(b)[both_hit]
        stats = {"both_hit": int(both_hit.sum()), "max_rel": float(rel.max()),
                 "median_rel": float(np.median(rel)), "px_gt_1e-4": int((rel > 1e-4).sum()),
                 "hit_on_one_side_only": int(((a <= far) != (b <= far)).sum())}
        ok = (stats["median_rel"] <= 1e-6
              and stats["px_gt_1e-4"] + stats["hit_on_one_side_only"] <= 5e-3 * a.size)
        return ok, stats

    # Phases 10-14 run on the scene as phases 7-9 used it (the sphere radius
    # at the fit's start, so that `target` gives a cotangent that is not zero):
    # the whole-frame kernel and plain renders of that scene are what the new
    # paths are held against.
    with torch.no_grad():
        frame_k = marcher.render().cpu().numpy()
        frame_p = plain.render().cpu().numpy()
    check(abs(radius.item() - START_RADIUS) < 1e-6, f"phases 10-14 see the radius {START_RADIUS}")

    small_cfg = {}
    for name in ("cell_colors", "palette"):
        expr = small[name]()
        for w, h in ((40, 24), (17, 13)):
            c = st.RenderConfig(w, h)
            small_cfg[(name, w, h)] = (expr, c)
            with torch.no_grad():
                ro, rd = camera_rays(w, h, view(), c.vfov_degrees, c.near, c.far)
                kd = rk.render_depth_rays_kernel(expr, ro, rd, c).cpu().numpy()
                kc = rk.render_rays_kernel(expr, ro, rd, c).cpu().numpy()
                pd_ = render_depth_rays(expr, ro, rd, c).cpu().numpy()
                pc = render_rays(expr, ro, rd, c).cpu().numpy()
                image_d = rk.render_depth_image_kernel(expr, view(), c).cpu().numpy()
            ok, stats = depth_close(kd, pd_)
            check(ok and kd.shape == (h, w), f"{name} depth {w}x{h} ray kernel vs plain {stats}")
            ok, stats = rgb_close(kc, pc)
            check(ok and kc.shape == (h, w, 3), f"{name} rgb {w}x{h} ray kernel vs plain {stats}")
            ok, stats = depth_close(kd, image_d)
            check(ok, f"{name} depth {w}x{h} ray kernel vs image kernel {stats}")
    n_scattered = 100_000
    sro, srd = scattered_rays(n_scattered, 11)
    with torch.no_grad():
        kd = rk.render_depth_rays_kernel(hero, v3(sro), v3(srd), cfg).cpu().numpy()
        kc = rk.render_rays_kernel(hero, v3(sro), v3(srd), cfg).cpu().numpy()
        pd_ = render_depth_rays(hero, v3(sro), v3(srd), cfg).cpu().numpy()
        pc = render_rays(hero, v3(sro), v3(srd), cfg).cpu().numpy()
    # A batch this large holds a few grazing rays beyond the small-frame
    # maximum of 1e-3 (measured 1.3e-3 on 3 rays), so they are counted
    # instead: at most 0.1% of the rays above 1e-4, median at most 1e-5.
    _, stats = depth_close(kd, pd_)
    ok = stats["median_rel"] <= 1e-5 and stats["px_gt_1e-4"] <= 1e-3 * n_scattered
    check(ok and kd.shape == (n_scattered,),
          f"{n_scattered} scattered rays, depth: ray kernel vs plain {stats}")
    ok, stats = distributional(kc, pc)
    check(ok and kc.shape == (n_scattered, 3),
          f"{n_scattered} scattered rays, rgb: ray kernel vs plain {stats}")
    sro, srd = sro[:1000], srd[:1000]  # the pullback's share: autograd keeps a tape of these

    # The slice at full size: the frame's camera rays through the ray kernel.
    rays_lib = build.load_rays(prog)
    print(f"build: ray-batch forward nvcc {rays_lib.build_seconds} s; registers per thread "
          f"{rays_lib.registers}, local memory {rays_lib.local_memory}")
    with torch.no_grad():
        ro, rd = camera_rays(WIDTH, HEIGHT, hero_view, cfg.vfov_degrees, cfg.near, cfg.far)
        torch.cuda.synchronize()
        rk.RAYS_LAUNCHES = 0
        rays_frame = rk.render_rays_kernel(hero, ro, rd, cfg)
        rays_depth = rk.render_depth_rays_kernel(hero, ro, rd, cfg)
        torch.cuda.synchronize()
        rays_launches = rk.RAYS_LAUNCHES
        image_depth = marcher.render_depth().cpu().numpy()
    check(rays_launches == 2, f"the 1920x1080 camera rays went through the ray kernel, RGB and "
                              f"depth (RAYS_LAUNCHES={rays_launches})")
    rays_frame_card = rays_frame.reshape(-1, 3)
    with torch.no_grad():
        rays6 = [c.contiguous().view(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
        flagged_frame, rays_hit = rk.launch_rays(rays_lib, params, rays6, cfg, True, want_hit=True)
        sky = (flagged_frame == torch.tensor([0.5, 0.75, 1.0], device=params.device)).all(-1)
        check(torch.equal(flagged_frame, rays_frame_card) and torch.equal(rays_hit, ~sky),
              f"the ray forward that also writes hit flags gives the same frame bit for bit, and "
              f"its {int(rays_hit.sum())} hit flags mark the rays not shaded as sky")
        # The same rays in a seeded shuffled order: rays are independent, so
        # each ray's colour, flag and depth are its own bit for bit, whatever
        # warp it marches in (a warp leaves the march when all its rays have
        # settled, which a shuffled warp seldom does).
        gen = torch.Generator(device=params.device).manual_seed(17)
        order = torch.randperm(WIDTH * HEIGHT, device=params.device, generator=gen)
        shuffled6 = [c[order].contiguous() for c in rays6]
        shuffled_frame, shuffled_hit = rk.launch_rays(rays_lib, params, shuffled6, cfg, True,
                                                      want_hit=True)
        shuffled_depth = rk.launch_rays(rays_lib, params, shuffled6, cfg, False)
        in_order_depth = rays_depth.reshape(-1)
        check(torch.equal(shuffled_frame.view(torch.int32), flagged_frame[order].view(torch.int32))
              and torch.equal(shuffled_hit, rays_hit[order])
              and torch.equal(shuffled_depth.view(torch.int32),
                              in_order_depth[order].view(torch.int32)),
              "the frame's rays in a seeded shuffled order: every ray's RGB, hit flag and depth "
              "are the in-order batch's, bit for bit")
        del flagged_frame, sky, shuffled_frame, shuffled_hit, shuffled_depth, in_order_depth
    rays_frame, rays_depth = rays_frame.cpu().numpy(), rays_depth.cpu().numpy()
    check(rays_frame.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(rays_frame).all()),
          f"ray-kernel frame {rays_frame.shape} is finite")
    ok, rays_stats = distributional(rays_frame, frame_p)
    check(ok, f"1920x1080 ray kernel vs plain render_rays {rays_stats}")
    ok, stats = distributional(rays_frame, frame_k)
    check(ok, f"1920x1080 ray kernel vs image kernel {stats}")
    ok, stats = hit_depth_close(rays_depth, image_depth, cfg.far)
    check(ok, f"1920x1080 depth, ray kernel vs image kernel where both hit {stats}")

    with torch.no_grad():
        origin_copy_ms = events(lambda: [c.contiguous() for c in (ro.x, ro.y, ro.z)])
        turn = {"image": [], "rays": [], "rays_shuffled": []}
        ray_runs = {"image": lambda: rk.launch(lib, params, v19, cfg, True),
                    "rays": lambda: rk.launch_rays(rays_lib, params, rays6, cfg, True),
                    "rays_shuffled": lambda: rk.launch_rays(rays_lib, params, shuffled6, cfg, True)}
        for which in ("image", "rays", "rays_shuffled", "rays_shuffled", "rays", "image"):
            turn[which].append(events(ray_runs[which]))
        rays_ms = float(np.mean(turn["rays"]))
        rays_shuffled_ms = float(np.mean(turn["rays_shuffled"]))
        rays_plain_ms = events(lambda: render_rays(hero, ro, rd, cfg), 1, 3)
        lone_rays_lib = build.load_rays(lone_prog)
        sky_rays_ms = device_events(lambda: rk.launch_rays(lone_rays_lib, lone_params, rays6, cfg,
                                                           True))
        # The ray-batch forward's own depth history: its depth render of i
        # iterations ends after i march steps, so the renders of 1 .. n - 1
        # iterations are the rows after the march's start. Each ray's
        # settled step is the first row that repeats, in the frame's order
        # and in the shuffled one (phase 12 takes the image forward's from
        # its store); every later row must equal it.
        def ray_history(rays):
            rows = [torch.full_like(rays[0], cfg.near - 0.1)]
            for i in range(1, cfg.depth_iterations):
                rows.append(rk.launch_rays(rays_lib, params, rays,
                                           st.RenderConfig(WIDTH, HEIGHT, depth_iterations=i),
                                           False))
            return torch.stack(rows)

        def rows_after_settled(history, steps):
            """Whether every row after a ray's settled step equals it, bit for bit."""
            bits = history.view(torch.int32)
            last = history.shape[0] - 1
            later = torch.arange(last + 1, device=history.device)[:, None] > steps[None, :]
            settled_row = bits.gather(0, torch.clamp(steps + 1, max=last)[None, :])
            return bool(((bits == settled_row) | ~later).all())

        rays_history = ray_history(rays6)
        rays_steps = settled_steps(rays_history)
        rays_rows_ok = rows_after_settled(rays_history, rays_steps)
        del rays_history
        shuffled_history = ray_history(shuffled6)
        rays_shuffled_steps = settled_steps(shuffled_history)
        rays_shuffled_rows_ok = rows_after_settled(shuffled_history, rays_shuffled_steps)
        del shuffled_history, shuffled6
    rays_settled = rays_steps < cfg.depth_iterations - 1
    check(rays_rows_ok and rays_shuffled_rows_ok and int(rays_settled.sum()) > 0
          and torch.equal(rays_shuffled_steps, rays_steps[order]),
          f"the ray-batch forward's own depth history (its depth renders of 1 to "
          f"{cfg.depth_iterations - 1} iterations): {int(rays_settled.sum())} of {WIDTH * HEIGHT} "
          f"rays settle before the last march step (mean settled step "
          f"{float(rays_steps[rays_settled].float().mean()):.2f}), every later row equals the "
          f"settled one, and the shuffled batch's settled steps are the same rays' in order")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing ray-batch forward launch alone: {rays_ms:.4f} ms (rounds {turn['rays']}), "
          f"the same rays shuffled {rays_shuffled_ms:.4f} ms (rounds {turn['rays_shuffled']}), "
          f"beside the image kernel's {float(np.mean(turn['image'])):.4f} ms (rounds "
          f"{turn['image']}) at {WIDTH}x{HEIGHT}x40; on the mostly-sky frame {sky_rays_ms:.4f} ms "
          f"(on the card: launches queued behind a sleep); the three stride-0 origin components "
          f"of camera_rays made contiguous: {origin_copy_ms:.4f} ms per frame; plain render_rays "
          f"{rays_plain_ms:.4f} ms on {smi}")

    # -- 11. the ray-batch pullback ---------------------------------------------
    def ray_grads(expr, ro_np, rd_np, c, kernel, depth):
        """(flat leaf gradients, (n, 3) d loss / d ro, d loss / d rd)."""
        for q in st.leaves(expr):
            q.grad = None
        tro, trd = v3(ro_np, True), v3(rd_np, True)
        if kernel:
            fn = rk.render_depth_rays_kernel if depth else rk.render_rays_kernel
        else:
            fn = render_depth_rays if depth else render_rays
        out = fn(expr, tro, trd, c)
        if depth:
            loss = (torch.where(out < 50.0, out, torch.zeros_like(out)) ** 2).sum()
        else:
            loss = (out ** 2).sum()
        loss.backward()
        torch.cuda.synchronize()
        flat = torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad).reshape(-1)
                          for q in st.leaves(expr)]).cpu().numpy()
        stack = lambda v: np.stack([comp.grad.cpu().numpy() for comp in (v.x, v.y, v.z)], -1)
        return flat, stack(tro), stack(trd)

    def ray_grads_close(got, ref, depth) -> tuple[bool, dict]:
        """Leaves as in phase 6 (rtol 2e-3 plus 1e-2 of the largest entry for
        RGB, 2e-3 of it for depth). The per-ray cotangents of ``ro`` and
        ``rd`` get 5e-2 of their largest entry for RGB: a single ray's tap
        cancellation noise is not averaged over a frame as a leaf's is
        (measured 2.0e-2 on the card, where the kernel contracts FMAs and the
        plain path does not; 5e-3 between two IEEE programs on the CPU). They
        are also held by their median, at most 1e-3 of the largest entry. In
        depth mode they get 1e-2: a grazing ray's cotangent grows by
        (1 + grad d . rd) per step, so the two programs' ulps compound on that
        one ray as they do in its depth (measured 2.7e-3)."""
        stats, ok = {}, True
        for name, a, b in zip(("leaves", "ro", "rd"), got, ref):
            if name == "leaves":
                share = 2e-3 if depth else 1e-2
            else:
                share = 1e-2 if depth else 5e-2
            largest = float(np.abs(b).max())
            err = np.abs(a - b)
            stats[name + "_err_of_largest"] = float(err.max() / max(largest, 1e-30))
            stats["max_abs_err"] = max(stats.get("max_abs_err", 0.0), float(err.max()))
            ok = (ok and bool(np.isfinite(a).all())
                  and np.allclose(a, b, rtol=2e-3, atol=1e-5 + share * largest)
                  and float(np.median(err)) <= 1e-3 * largest)
        return ok, stats

    rays_bwd_err = rays_bwd_share = 0.0
    for (name, w, h), (expr, c) in small_cfg.items():
        with torch.no_grad():
            ro_s, rd_s = camera_rays(w, h, view((-2.0, 2.0, 4.0)), c.vfov_degrees, c.near, c.far)
        ro_np = np.stack([comp.expand(h, w).cpu().numpy() for comp in (ro_s.x, ro_s.y, ro_s.z)], -1)
        rd_np = np.stack([comp.cpu().numpy() for comp in (rd_s.x, rd_s.y, rd_s.z)], -1)
        for depth in (False, True):
            ok, stats = ray_grads_close(ray_grads(expr, ro_np, rd_np, c, True, depth),
                                        ray_grads(expr, ro_np, rd_np, c, False, depth), depth)
            check(ok, f"{name} {'depth' if depth else 'rgb'} {w}x{h} ray pullback vs autograd of "
                      f"plain render_rays, every leaf, ro and rd {stats}")
            if not depth:  # depth gradients reach ~1e6: their absolute errors say little
                rays_bwd_err = max(rays_bwd_err, stats["max_abs_err"])
                rays_bwd_share = max(rays_bwd_share, *(stats[k + "_err_of_largest"]
                                                       for k in ("leaves", "ro", "rd")))
    for depth in (False, True):
        ok, stats = ray_grads_close(ray_grads(hero, sro, srd, cfg, True, depth),
                                    ray_grads(hero, sro, srd, cfg, False, depth), depth)
        check(ok, f"SphereRepeat, 1000 scattered rays, {'depth' if depth else 'rgb'}: ray pullback "
                  f"vs autograd {stats}")

    # A gradient step at full size through render_rays_kernel, as a user calls it.
    for q in st.leaves(hero):
        q.grad = None
    torch.cuda.synchronize()
    rk.RAYS_LAUNCHES = rk.RAYS_BWD_LAUNCHES = 0
    torch.mean((rk.render_rays_kernel(hero, ro, rd, cfg) - target) ** 2).backward()
    torch.cuda.synchronize()
    rays_step_launches = (rk.RAYS_LAUNCHES, rk.RAYS_BWD_LAUNCHES)
    rays_bwd_lib = build.load_rays_bwd(prog)
    rays_leaf_grad = torch.cat([q.grad.reshape(-1) for q in st.leaves(hero)]).cpu().numpy()
    print(f"build: ray-batch backward nvcc {rays_bwd_lib.build_seconds} s; registers per thread "
          f"{rays_bwd_lib.registers}, local memory {rays_bwd_lib.local_memory}")
    check(rays_step_launches == (1, 1),
          f"a 1920x1080 gradient step through render_rays_kernel launched the ray kernels "
          f"(RAYS_LAUNCHES, RAYS_BWD_LAUNCHES) = {rays_step_launches}")
    # The pullback at full size against autograd of plain render_rays on the
    # same rays, both fed the same cotangent (the loss's at the ray kernel's
    # own frame), in chunks whose tape fits: the ray cotangents of every ray,
    # and the chunks' parameter sums. A grazing ray multiplies its cotangent
    # by (1 + grad d . rd) per step, up to ~1e6 over 39 steps, and the same
    # factor turns an ulp into a different end of its march: such a ray is
    # one of the few whose colour differs between the ray kernel's frame and
    # the plain path's (phase 10 holds their number under 0.5%), and a single
    # one can carry half of a leaf's sum. So the parameter sums are held over
    # the rays on which the two forwards agree to 1e-2 (the cotangent of the
    # others set to zero on both sides), to 1e-2 of the largest entry, the
    # small frames' bound (measured 6e-4); every ray, the others too, is held
    # by the count contract of `per_ray_close`. The sums over all rays are
    # printed.
    def per_ray_close(got, ref) -> tuple[bool, dict]:
        """(6, n) ray cotangents of two programs. A ray's error is its largest
        component error over the ray's own largest cotangent entry (over the
        median ray's where it is smaller: cotangents span six decades, so an
        error held to the batch's largest entry would let an all-zero result
        pass). The eps=1e-5 normal leaves every ray ~1e-3 of tap cancellation
        noise, and grazing rays compound ulps: the median over the rays that
        have a cotangent is held to 5e-3 (measured 1.3e-3), and at most 0.5%
        of the rays may be off by more than 5e-2 (measured 0.17%) and 0.05% by
        more than 0.5 (measured 0.011%)."""
        size = ref.abs().amax(0)
        live = size > 0
        err = (got - ref).abs().amax(0) / torch.clamp(size, min=size[live].median())
        n = err.numel()
        stats = {"rays": n, "with_a_cotangent": int(live.sum()),
                 "median_rel": float(err[live].median()), "rays_gt_5e-2": int((err > 5e-2).sum()),
                 "rays_gt_0.5": int((err > 0.5).sum())}
        ok = (bool(torch.isfinite(got).all()) and stats["median_rel"] <= 5e-3
              and stats["rays_gt_5e-2"] <= 5e-3 * n and stats["rays_gt_0.5"] <= 5e-4 * n)
        return ok, stats

    n_chunks = 4
    chunk = WIDTH * HEIGHT // n_chunks
    hero_leaves = st.leaves(hero)
    with torch.no_grad():
        mse = 2.0 / target.numel()
        target_flat = target.reshape(-1, 3)
        cot_rays = (mse * (rays_frame_card - target_flat)).contiguous()
        plain_sums = torch.zeros(n_chunks, params.numel(), device=params.device)
        kernel_sums = torch.zeros_like(plain_sums)  # both over the rays whose forwards agree
        plain_all = torch.zeros_like(params)  # over every ray
        kernel_all = torch.zeros_like(params)
        plain_g_rays = torch.empty(6, WIDTH * HEIGHT, device=params.device)
        kernel_g_rays = torch.empty_like(plain_g_rays)
    disagreeing = 0
    for ci in range(n_chunks):
        part = slice(ci * chunk, (ci + 1) * chunk)
        comps = [c[part].clone().requires_grad_() for c in rays6]
        out = render_rays(hero, st.V3(*comps[:3]), st.V3(*comps[3:]), cfg)

        def pull(c):
            g = torch.autograd.grad(out, hero_leaves + comps, c, retain_graph=True,
                                    allow_unused=True)
            flat = torch.cat([(torch.zeros_like(q) if gq is None else gq).reshape(-1)
                              for q, gq in zip(hero_leaves, g)])
            return flat, torch.stack(g[len(hero_leaves):])

        with torch.no_grad():
            agree = (out - rays_frame_card[part]).abs().amax(-1, keepdim=True) <= 1e-2
            cot_agree = (cot_rays[part] * agree).contiguous()
            disagreeing += int((~agree).sum())
        leaf_sum, plain_g_rays[:, part] = pull(cot_rays[part])
        plain_all += leaf_sum
        plain_sums[ci] = pull(cot_agree)[0]
        with torch.no_grad():
            chunk_rays = [c[part] for c in rays6]
            leaf_sum, kernel_g_rays[:, part] = rk.launch_rays_bwd(
                rays_bwd_lib, params, chunk_rays, cfg, True, cot_rays[part], rays_hit[part])
            kernel_all += leaf_sum
            kernel_sums[ci] = rk.launch_rays_bwd(rays_bwd_lib, params, chunk_rays, cfg, True,
                                                 cot_agree, rays_hit[part])[0]
        del out, comps, pull
    torch.cuda.synchronize()
    with torch.no_grad():
        plain_total, kernel_total = plain_sums.sum(0), kernel_sums.sum(0)
        largest = float(plain_total.abs().max())
        rays_full_err = float((kernel_total - plain_total).abs().max()) / largest
        rays_chunk_err = float((kernel_sums - plain_sums).abs().max()) / largest
        check(bool(torch.isfinite(kernel_sums).all()) and rays_full_err <= 1e-2
              and rays_chunk_err <= 1e-2,
              f"leaf gradients of the 1920x1080 loss over the {WIDTH * HEIGHT - disagreeing} rays "
              f"whose colour the two forwards agree on to 1e-2, ray pullback vs autograd of plain "
              f"render_rays on the same rays and the same cotangent: {rays_full_err:.3g} of the "
              f"largest entry ({largest:.6g}); the worst of the {n_chunks} chunks' sums "
              f"{rays_chunk_err:.3g} of it (bound 1e-2; all zeros would give 1)")
        ok, rays_full_stats = per_ray_close(kernel_g_rays, plain_g_rays)
        check(ok, f"ray cotangents of all {WIDTH * HEIGHT} rays, ray pullback vs autograd of plain "
                  f"render_rays {rays_full_stats}")
        # The check must fail a wrong kernel: all zeros, a wrong sign, and
        # direction cotangents 5% too large.
        scaled = kernel_g_rays.clone()
        scaled[3:] *= 1.05
        wrong = {"all zeros": torch.zeros_like(kernel_g_rays), "negated": -kernel_g_rays,
                 "rd cotangents times 1.05": scaled}
        passed = [name for name, bad in wrong.items() if per_ray_close(bad, plain_g_rays)[0]]
        check(not passed, f"the ray-cotangent contract refuses {list(wrong)} (passed: {passed})")
        del scaled, wrong
        step_err = float((torch.from_numpy(rays_leaf_grad).to(kernel_all) - kernel_all)
                         .abs().max()) / float(kernel_all.abs().max())
        check(step_err <= 1e-4,
              f"the gradient step's leaf gradients equal the {n_chunks} chunks' sum to float "
              f"addition order: {step_err:.3g} of the largest entry (bound 1e-4)")
        all_largest = float(plain_all.abs().max())
        print(f"INFO over all {WIDTH * HEIGHT} rays the same two sums are "
              f"{float((kernel_all - plain_all).abs().max()) / all_largest:.3g} of the largest "
              f"entry ({all_largest:.6g}) apart: the {disagreeing} rays whose colours differ by "
              f"more than 1e-2 carry the rest")
    print(f"INFO the gradient step's leaf gradients, ray kernels vs image kernels (rays that "
          f"differ in their last bits): "
          f"{float(np.abs(rays_leaf_grad - first[0]).max()) / all_largest:.3g} of that entry")
    del plain_g_rays, kernel_g_rays, plain_sums, kernel_sums, cot_rays
    for q in st.leaves(hero):
        q.grad = None
    torch.cuda.empty_cache()
    with torch.no_grad():
        g1 = rk.launch_rays_bwd(rays_bwd_lib, params, rays6, cfg, True, cot, rays_hit)
        g2 = rk.launch_rays_bwd(rays_bwd_lib, params, rays6, cfg, True, cot, rays_hit)
        torch.cuda.synchronize()
        check(bool(torch.equal(g1[0], g2[0]) and torch.equal(g1[1], g2[1])
                   and torch.isfinite(g1[0]).all() and torch.isfinite(g1[1]).all()),
              "two ray-pullback launches give bit-identical, finite gradients (parameters and rays)")
        # Without the hit flags every ray is marched and the final shade's own
        # sky test zeroes the misses: the same cotangent on every ray the
        # forward hit, bit for bit (the flag only decides whether a ray is
        # marched). The march's depths against the forward's: the RGB pullback
        # stops before the final step, where a depth render of n - 1
        # iterations ends. sdf_dist_unit gives the tangent march its
        # distances and sdf_dist the forward; a ray whose two marches part
        # in the last bits is counted, not refused (the contracts above hold
        # either way).
        g0, g0_rays, marched_depth = rk.launch_rays_bwd(rays_bwd_lib, params, rays6, cfg, True,
                                                        cot, want_depths=True)
        fwd_depth = rk.launch_rays(rays_lib, params, rays6, st.RenderConfig(
            WIDTH, HEIGHT, depth_iterations=cfg.depth_iterations - 1), False)
        torch.cuda.synchronize()
        hit_rays_same = torch.equal(g0_rays[:, rays_hit], g1[1][:, rays_hit])
        sky_rays_zero = bool((g1[1][:, ~rays_hit] == 0).all())
        found_by_march = int((g0_rays[:, ~rays_hit] != 0).any(0).sum())
        depths_apart = int((marched_depth != fwd_depth).sum())
        check(sky_rays_zero and hit_rays_same and found_by_march <= 5e-3 * WIDTH * HEIGHT,
              f"the ray pullback with the forward's hit flags and without them: ray cotangents "
              f"{'bit-identical' if hit_rays_same else 'not bit-identical'} on the "
              f"{int(rays_hit.sum())} rays the forward hit, the {int((~rays_hit).sum())} flagged "
              f"misses zero; {found_by_march} flagged misses that the march alone shades; the "
              f"march's depth before the final step differs from the forward's (a depth render "
              f"of {cfg.depth_iterations - 1} iterations) on {depths_apart} rays, bit for bit")
        rays_depths_apart = depths_apart
        del g0, g0_rays, marched_depth, fwd_depth
        # The full-size launch walks its rays with a grid-stride loop, several
        # rays a thread (its grid is one wave of 128-thread blocks). In pieces
        # small enough for one ray a thread (the
        # regime of the small-frame checks) it must give the same ray
        # cotangents bit for bit and the same parameter sums to float32
        # addition order (1e-5 of the largest entry).
        piece = rays_bwd_lib.rows(WIDTH * HEIGHT, 1) * 128
        pieces = torch.zeros_like(g1[0], dtype=torch.float64)
        same_rays = True
        for s0 in range(0, WIDTH * HEIGHT, piece):
            gp, gr = rk.launch_rays_bwd(rays_bwd_lib, params, [c[s0:s0 + piece] for c in rays6],
                                        cfg, True, cot[s0:s0 + piece], rays_hit[s0:s0 + piece])
            pieces += gp.double()
            same_rays = same_rays and torch.equal(gr, g1[1][:, s0:s0 + piece])
        torch.cuda.synchronize()
        piece_err = float((pieces - g1[0].double()).abs().max() / g1[0].abs().max())
        check(same_rays and piece_err <= 1e-5,
              f"the full-size ray pullback against itself in {-(-WIDTH * HEIGHT // piece)} pieces "
              f"of one ray a thread: ray cotangents bit-identical, parameter sums "
              f"{piece_err:.3g} of the largest entry apart (bound 1e-5)")
        del g1, g2, gp, gr
        turn = {"image": [], "rays": [], "rays_unflagged": []}
        runs = {
            "image": lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot),
            "rays": lambda: rk.launch_rays_bwd(rays_bwd_lib, params, rays6, cfg, True, cot,
                                               rays_hit),
            "rays_unflagged": lambda: rk.launch_rays_bwd(rays_bwd_lib, params, rays6, cfg, True,
                                                         cot),
        }
        for which in ("image", "rays", "rays_unflagged", "rays_unflagged", "rays", "image"):
            turn[which].append(events(runs[which]))
        # The same on the mostly-sky frame: the hit flags spare the misses the march.
        lone_rays_lib = build.load_rays(lone_prog)
        lone_rays_bwd_lib = build.load_rays_bwd(lone_prog)
        lone_frame, lone_hit = rk.launch_rays(lone_rays_lib, lone_params, rays6, cfg, True,
                                              want_hit=True)
        lone_cot = ((2.0 / lone_frame.numel()) * (lone_frame - 0.5)).contiguous()
        lone_g = rk.launch_rays_bwd(lone_rays_bwd_lib, lone_params, rays6, cfg, True, lone_cot,
                                    lone_hit)
        check(bool(torch.isfinite(lone_g[0]).all()) and float(lone_g[0].abs().max()) > 0
              and int(lone_hit.sum()) < 0.1 * WIDTH * HEIGHT,
              f"the mostly-sky frame's rays ({int(lone_hit.sum())} hit) have a finite ray pullback")
        sky_turn = {"rays": [], "rays_unflagged": []}
        sky_runs = {
            "rays": lambda: rk.launch_rays_bwd(lone_rays_bwd_lib, lone_params, rays6, cfg, True,
                                               lone_cot, lone_hit),
            "rays_unflagged": lambda: rk.launch_rays_bwd(lone_rays_bwd_lib, lone_params, rays6,
                                                         cfg, True, lone_cot),
        }
        for which in ("rays", "rays_unflagged", "rays_unflagged", "rays"):
            sky_turn[which].append(events(sky_runs[which]))
        del lone_frame, lone_cot, lone_g
    rays_bwd_ms = float(np.mean(turn["rays"]))
    rays_bwd_unflagged_ms = float(np.mean(turn["rays_unflagged"]))
    sky_rays_bwd_ms = float(np.mean(sky_turn["rays"]))
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing ray-batch backward launch alone (pullback + reduction), with the forward's hit "
          f"flags: {rays_bwd_ms:.4f} ms (rounds {turn['rays']}), without them "
          f"{float(np.mean(turn['rays_unflagged'])):.4f} ms (rounds {turn['rays_unflagged']}), "
          f"beside the image backward's {float(np.mean(turn['image'])):.4f} ms (rounds "
          f"{turn['image']}) at {WIDTH}x{HEIGHT}x40; on the mostly-sky frame "
          f"{sky_rays_bwd_ms:.4f} ms with the flags, "
          f"{float(np.mean(sky_turn['rays_unflagged'])):.4f} ms without them on {smi}")
    del ro, rd, rays6
    for q in st.leaves(hero):
        q.grad = None
    torch.cuda.empty_cache()

    # -- 12. the depth-history handoff ------------------------------------------
    def history_close(got, ref, far) -> tuple[bool, dict]:
        """(n, rays) depth histories of two programs, on the rays that hit in
        both: the depth contract of a large batch (phase 10), median relative
        error at most 1e-5, and at most 0.5% of the rays more than 1e-4 off in
        any of their rows or hitting on one side only (grazing rays, where an
        ulp compounds over the steps). Early rows differ by everything between
        neighbours, so rows that are shifted or permuted fail on every ray."""
        hit_got, hit_ref = got[-1] <= far, ref[-1] <= far
        both = hit_got & hit_ref
        rel = ((got - ref).abs() / ref.abs().clamp(min=1.0))[:, both]
        worst = rel.amax(0)
        stats = {"both_hit": int(both.sum()), "hit_on_one_side_only": int((hit_got != hit_ref).sum()),
                 "median_rel": float(rel.flatten().median()), "max_rel": float(worst.max()),
                 "rays_gt_1e-4": int((worst > 1e-4).sum()), "rays_gt_1e-3": int((worst > 1e-3).sum())}
        ok = (bool(torch.isfinite(got[:, both]).all()) and stats["median_rel"] <= 1e-5
              and stats["rays_gt_1e-4"] + stats["hit_on_one_side_only"] <= 5e-3 * got.shape[1])
        return ok, stats

    def store_grads(expr, w, h, v, depth, iters=40):
        """(flat leaf gradients, view gradient) of phase 6's losses through
        the forward with store and the store-fed backward, launched by hand as
        ``_RenderImage`` launches the replay pair."""
        c = st.RenderConfig(w, h, depth_iterations=iters)
        sp = compile_scene(expr)
        v = v.clone().requires_grad_()
        v_s = rk.view19(v, c)
        with torch.no_grad():
            p_s = flat_params(expr).contiguous()
            out, history = rk.launch(build.load(sp, store=True), p_s, v_s.detach(), c, not depth,
                                     want_store=True)
            g = torch.where(out < 50.0, 2.0 * out, torch.zeros_like(out)) if depth else 2.0 * out
            fed = rk.launch_bwd(build.load_bwd(sp, store=True), p_s, v_s.detach(), c, not depth,
                                g.contiguous(), store=history)
        v_s.backward(fed[p_s.numel():])
        torch.cuda.synchronize()
        return fed[:p_s.numel()].cpu().numpy(), v.grad.cpu().numpy()

    store_bwd_err = 0.0
    for name, expr, w, h in bwd_cases:
        for depth in (False, True):
            ok, stats = grads_close(store_grads(expr, w, h, view((-2.0, 2.0, 4.0)), depth),
                                    bwd_refs[(name, w, h, depth)], depth)
            check(ok, f"{name} {'depth' if depth else 'rgb'} {w}x{h} store-fed backward vs autograd "
                      f"of the plain path, every leaf and the view {stats}")
            if name == "union":
                store_bwd_err = max(store_bwd_err, stats["max_abs_err"])

    store_err = 0.0
    for (name, w, h), (expr, c) in small_cfg.items():
        sp = compile_scene(expr)
        with torch.no_grad():
            p_s = flat_params(expr).contiguous()
            v_s = rk.view19(view(), c)
            out_s, store_s = rk.launch(build.load(sp, store=True), p_s, v_s, c, True,
                                       want_store=True)
            ro_s, rd_s = camera_rays(w, h, view(), c.vfov_degrees, c.near, c.far)
            history = march_history(expr, ro_s, rd_s, c).reshape(c.depth_iterations, -1)
            hit = history[-1] <= c.far
            a, b = store_s[:, hit].cpu().numpy(), history[:, hit].cpu().numpy()
            g_s = torch.from_numpy(np.random.default_rng(3).standard_normal((w * h, 3))
                                   .astype(np.float32)).cuda()
            fed = rk.launch_bwd(build.load_bwd(sp, store=True), p_s, v_s, c, True, g_s,
                                store=store_s)
            replay = rk.launch_bwd(build.load_bwd(sp), p_s, v_s, c, True, g_s)
        torch.cuda.synchronize()
        store_err = max(store_err, float(np.abs(a - b).max()))
        # Every row of the rays that hit, by the depth contract between two
        # programs (the kernel contracts FMAs; rtol 1e-4 holds between the g++
        # build and the plain path in the CPU tests, not here).
        ok, stats = depth_close(a, b)
        check(ok and store_s.shape == (c.depth_iterations, w * h),
              f"{name} {w}x{h} depth history vs march_history, all {c.depth_iterations} rows of "
              f"the {int(hit.sum())} hit rays {stats}")
        largest = float(replay.abs().max())
        diff = float((fed - replay).abs().max()) / largest
        check(diff <= 1e-6, f"{name} {w}x{h} store-fed pullback vs replay: "
                            f"{'bit-identical' if torch.equal(fed, replay) else f'{diff:.3g} of the largest entry'}")

    store_lib = build.load(prog, store=True)
    store_bwd_lib = build.load_bwd(prog, store=True)
    print(f"build: forward with store nvcc {store_lib.build_seconds} s, registers "
          f"{store_lib.registers}, local memory {store_lib.local_memory}; backward fed the store "
          f"nvcc {store_bwd_lib.build_seconds} s, registers {store_bwd_lib.registers}, local "
          f"memory {store_bwd_lib.local_memory} (replay: {bwd_lib.registers}, "
          f"{bwd_lib.local_memory})")
    with torch.no_grad():
        torch.cuda.synchronize()
        rk.STORE_LAUNCHES = rk.STORE_BWD_LAUNCHES = 0
        out_store, store = rk.launch(store_lib, params, v19, cfg, True, want_store=True)
        fed = rk.launch_bwd(store_bwd_lib, params, v19, cfg, True, cot, store=store)
        torch.cuda.synchronize()
        store_launches = (rk.STORE_LAUNCHES, rk.STORE_BWD_LAUNCHES)
        replay = rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot)
        check(store_launches == (1, 1), f"a forward with store and a store-fed backward at "
              f"{WIDTH}x{HEIGHT} (STORE_LAUNCHES, STORE_BWD_LAUNCHES) = {store_launches}")
        check(torch.equal(out_store, rk.launch(lib, params, v19, cfg, True)),
              "the frame of the forward with store equals the forward's, bit for bit")
        check(store.shape == (cfg.depth_iterations, WIDTH * HEIGHT)
              and bool((store[0] == np.float32(cfg.near - 0.1)).all()),
              f"the store is {tuple(store.shape)} ({store.numel() * 4 / 1e6:.1f} MB) and row 0 is "
              f"near - 0.1")
        for i in (1, 20, 39):
            depth_i = rk.launch(lib, params, v19,
                                st.RenderConfig(WIDTH, HEIGHT, depth_iterations=i), False)
            check(torch.equal(store[i], depth_i),
                  f"store row {i} equals the depth render of {i} iterations, bit for bit")
        del depth_i
        # Where each ray's march reaches its bitwise fixed point: the first
        # step that left its depth unchanged. Every later row equals it (the
        # forward writes those rows without stepping), and a warp of 32
        # pixels leaves the march when all of them have settled.
        n_it = cfg.depth_iterations
        steps = settled_steps(store)
        rows_after_ok = rows_after_settled(store, steps)
        settled = steps < n_it - 1
        ray_need = torch.clamp(steps + 1, max=n_it - 1)
        ray_saved = float(1 - ray_need.sum() / (ray_need.numel() * (n_it - 1)))
        check(rows_after_ok and int(settled.sum()) > 0,
              f"{int(settled.sum())} of {WIDTH * HEIGHT} rays reach their bitwise fixed point "
              f"before the last march step (mean settled step "
              f"{float(steps[settled].float().mean()):.2f} of {n_it - 1}); every row of the store "
              f"after a ray's settled step equals it, bit for bit")
        print(f"work: march steps saved by leaving at the fixed point, SphereRepeat "
              f"{WIDTH}x{HEIGHT}x{n_it}, ray by ray: {ray_saved:.4f} of the ray-steps (the image "
              f"forward's store)")
        largest = float(replay.abs().max())
        store_vs_replay = float((fed - replay).abs().max())
        same = torch.equal(fed, replay)
        check(store_vs_replay <= 1e-6 * largest and bool(torch.isfinite(fed).all()),
              f"{WIDTH}x{HEIGHT} store-fed pullback vs replay: "
              f"{'bit-identical' if same else f'{store_vs_replay / largest:.3g} of the largest entry'}")
        fed2 = rk.launch_bwd(store_bwd_lib, params, v19, cfg, True, cot, store=store)
        check(torch.equal(fed, fed2), "two store-fed backward launches give bit-identical gradients")
        # Two bands of an odd pixel count, so that no row of a band's store
        # starts on a 16-byte boundary: each band's store is the whole
        # frame's columns bit for bit, its store-fed pullback the replay's
        # over the same pixels, and the two bands' sum the frame's to float
        # addition order (1e-4 of the largest entry).
        odd = 1_000_001
        band_sum = torch.zeros_like(fed, dtype=torch.float64)
        bands_ok, band_vs_replay = True, 0.0
        for b0, bn in ((0, odd), (odd, WIDTH * HEIGHT - odd)):
            _, band_store = rk.launch(store_lib, params, v19, cfg, True, b0, bn, want_store=True)
            band_fed = rk.launch_bwd(store_bwd_lib, params, v19, cfg, True, cot[b0:b0 + bn], b0, bn,
                                     store=band_store)
            band_replay = rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot[b0:b0 + bn], b0, bn)
            bands_ok = bands_ok and torch.equal(band_store, store[:, b0:b0 + bn])
            band_vs_replay = max(band_vs_replay, float((band_fed - band_replay).abs().max()))
            band_sum += band_fed.double()
        del band_store, band_fed, band_replay
        band_err = float((band_sum - fed.double()).abs().max()) / largest
        check(bands_ok and band_vs_replay <= 1e-6 * largest and band_err <= 1e-4,
              f"two bands of {odd} and {WIDTH * HEIGHT - odd} pixels: stores equal to the frame's "
              f"columns bit for bit, store-fed pullback vs replay "
              f"{band_vs_replay / largest:.3g} of the largest entry (bound 1e-6), the bands' sum "
              f"vs the frame's {band_err:.3g} (bound 1e-4)")
        handoff = {"fwd": [], "fwd_store": [], "bwd": [], "bwd_store": []}
        runs = {
            "fwd": lambda: rk.launch(lib, params, v19, cfg, True),
            "fwd_store": lambda: rk.launch(store_lib, params, v19, cfg, True, want_store=True),
            "bwd": lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot),
            "bwd_store": lambda: rk.launch_bwd(store_bwd_lib, params, v19, cfg, True, cot,
                                               store=store),
        }
        for which in ("fwd", "fwd_store", "bwd", "bwd_store", "bwd_store", "bwd", "fwd_store",
                      "fwd"):
            handoff[which].append(events(runs[which]))
        ro, rd = camera_rays(WIDTH, HEIGHT, hero_view, cfg.vfov_degrees, cfg.near, cfg.far)
        history_ms = events(lambda: march_history(hero, ro, rd, cfg), 1, 3)
        history = march_history(hero, ro, rd, cfg).reshape(cfg.depth_iterations, -1)
        del ro, rd
        ok, store_full_stats = history_close(store, history, cfg.far)
        check(ok, f"{WIDTH}x{HEIGHT} depth history vs plain march_history, all "
                  f"{cfg.depth_iterations} rows {store_full_stats}")
        check(not history_close(torch.roll(store, 1, 0), history, cfg.far)[0],
              "the depth-history contract refuses a store whose rows are shifted by one")
        del history
    handoff_ms = {k: float(np.mean(v)) for k, v in handoff.items()}
    # Both backwards on the mostly-sky frame, in turns: a sky pixel reads its
    # final depth and stops.
    with torch.no_grad():
        lone_store_lib = build.load(lone_prog, store=True)
        lone_store_bwd_lib = build.load_bwd(lone_prog, store=True)
        lone_frame, lone_store = rk.launch(lone_store_lib, lone_params, v19, cfg, True,
                                           want_store=True)
        lone_cot = ((2.0 / lone_frame.numel()) * (lone_frame - 0.5)).contiguous()
        lone_fed = rk.launch_bwd(lone_store_bwd_lib, lone_params, v19, cfg, True, lone_cot,
                                 store=lone_store)
        lone_replay = rk.launch_bwd(lone_bwd, lone_params, v19, cfg, True, lone_cot)
        lone_largest = float(lone_replay.abs().max())
        check(float((lone_fed - lone_replay).abs().max()) <= 1e-6 * lone_largest,
              "the mostly-sky frame: store-fed pullback vs replay within 1e-6 of the largest entry")
        sky_handoff = {"bwd": [], "bwd_store": []}
        sky_runs = {
            "bwd": lambda: rk.launch_bwd(lone_bwd, lone_params, v19, cfg, True, lone_cot),
            "bwd_store": lambda: rk.launch_bwd(lone_store_bwd_lib, lone_params, v19, cfg, True,
                                               lone_cot, store=lone_store),
        }
        for which in ("bwd", "bwd_store", "bwd_store", "bwd"):
            sky_handoff[which].append(events(sky_runs[which]))
        sky_store_ms = device_events(lambda: rk.launch(lone_store_lib, lone_params, v19, cfg,
                                                       True, want_store=True))
        lone_steps = settled_steps(lone_store)
        del lone_frame, lone_store, lone_cot, lone_fed, lone_replay
    sky_store_bwd_ms = float(np.mean(sky_handoff["bwd_store"]))
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing the mostly-sky frame's backwards, launches alone: with replay "
          f"{float(np.mean(sky_handoff['bwd'])):.4f} ms, fed the store {sky_store_bwd_ms:.4f} ms "
          f"(rounds {sky_handoff}); its forward with store {sky_store_ms:.4f} ms (on the card: "
          f"launches queued behind a sleep) at {WIDTH}x{HEIGHT}x40 on {smi}")
    print(f"timing handoff at {WIDTH}x{HEIGHT}x40, launches alone: forward {handoff_ms['fwd']:.4f} "
          f"ms, forward with store {handoff_ms['fwd_store']:.4f} ms, backward with replay "
          f"{handoff_ms['bwd']:.4f} ms, backward fed the store {handoff_ms['bwd_store']:.4f} ms; "
          f"pair with replay {handoff_ms['fwd'] + handoff_ms['bwd']:.4f} ms, pair with handoff "
          f"{handoff_ms['fwd_store'] + handoff_ms['bwd_store']:.4f} ms (rounds {handoff}); plain "
          f"march_history {history_ms:.4f} ms on {smi}")
    del store, out_store, fed, fed2, replay
    torch.cuda.empty_cache()

    # -- 13. row bands and resumable tiles ---------------------------------------
    split = 500  # rows of the first band
    with torch.no_grad():
        ivp, cam = inv_view_proj(hero_view, WIDTH, HEIGHT, cfg.vfov_degrees, cfg.near, cfg.far)
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    for q in st.leaves(hero):
        q.grad = None
    ivp_g, cam_g = ivp.clone().requires_grad_(), cam.clone().requires_grad_()
    top = rk.render_rows_kernel(hero, ivp_g, cam_g, 0, cfg, split)
    bottom = rk.render_rows_kernel(hero, ivp_g, cam_g, torch.tensor(split * WIDTH), cfg,
                                   HEIGHT - split)
    bands = torch.cat([top, bottom])
    torch.mean((bands - target) ** 2).backward()
    torch.cuda.synchronize()
    band_launches = (rk.LAUNCHES, rk.BWD_LAUNCHES)
    band_grad = torch.cat([q.grad.reshape(-1) for q in st.leaves(hero)]
                          + [ivp_g.grad.reshape(-1), cam_g.grad.reshape(-1)]).cpu().numpy()
    for q in st.leaves(hero):
        q.grad = None
    ivp_g, cam_g = ivp.clone().requires_grad_(), cam.clone().requires_grad_()
    whole = rk.render_rows_kernel(hero, ivp_g, cam_g, 0, cfg, HEIGHT)
    torch.mean((whole - target) ** 2).backward()
    torch.cuda.synchronize()
    whole_grad = torch.cat([q.grad.reshape(-1) for q in st.leaves(hero)]
                           + [ivp_g.grad.reshape(-1), cam_g.grad.reshape(-1)]).cpu().numpy()
    check(band_launches == (2, 2), f"two row bands went through the image kernels, forward and "
                                   f"backward (LAUNCHES, BWD_LAUNCHES) = {band_launches}")
    check(np.array_equal(bands.detach().cpu().numpy(), frame_k)
          and np.array_equal(whole.detach().cpu().numpy(), frame_k),
          f"rows 0-{split} and {split}-{HEIGHT} through render_rows_kernel equal the whole-frame "
          f"kernel render bit for bit")
    # Each launch sums its pixels in float32 in its own grouping (grid-stride
    # threads, blocks, rows of partials), so the bands' sum differs from the
    # frame's by float addition order: held to 1e-4 of the largest entry.
    band_err = float(np.abs(band_grad - whole_grad).max() / np.abs(whole_grad).max())
    check(band_err <= 1e-4, f"the two bands' summed gradient (leaves, ivp, cam) vs the frame's: "
                            f"{band_err:.3g} of the largest entry (bound 1e-4)")
    del top, bottom, bands, whole
    for q in st.leaves(hero):
        q.grad = None

    with tempfile.TemporaryDirectory(prefix="sdfkit_tiles_") as tiles_root:
        tiles_root = pathlib.Path(tiles_root)
        rk.LAUNCHES = 0
        t0 = time.perf_counter()
        tiled, stats = render_tiles_resumable(hero, WIDTH, HEIGHT, tiles_root / "full",
                                              tile_rows=TILE_ROWS, view=hero_view)
        tiles_s = time.perf_counter() - t0
        n_tiles = -(-HEIGHT // TILE_ROWS)
        check(stats == {"resumed": 0, "rendered": n_tiles, "tiles": n_tiles}
              and rk.LAUNCHES == n_tiles,
              f"render_tiles_resumable rendered {stats} with LAUNCHES={rk.LAUNCHES} in "
              f"{tiles_s:.3f} s (tile files written)")
        check(np.array_equal(tiled, frame_k),
              f"the {n_tiles} tiles equal the whole-frame kernel render bit for bit")
        manifest = json.loads((tiles_root / "full" / "manifest.json").read_text())
        check(manifest["backend"] == "kernel", f"the manifest records backend {manifest['backend']!r}")
        for t in (1, 4, 8):
            (tiles_root / "full" / f"tile_{t:05d}.npy").unlink()
        rk.LAUNCHES = 0
        resumed, stats = render_tiles_resumable(hero, WIDTH, HEIGHT, tiles_root / "full",
                                                tile_rows=TILE_ROWS, view=hero_view)
        check(stats == {"resumed": n_tiles - 3, "rendered": 3, "tiles": n_tiles}
              and rk.LAUNCHES == 3, f"three tile files deleted, then resumed: {stats}, "
                                    f"LAUNCHES={rk.LAUNCHES}")
        check(np.array_equal(resumed, tiled), "the resumed image equals the uninterrupted one bit "
                                              "for bit")
        with torch.no_grad():
            radius.fill_(0.51)
        try:
            render_tiles_resumable(hero, WIDTH, HEIGHT, tiles_root / "full", tile_rows=TILE_ROWS,
                                   view=hero_view)
            refused = False
        except ValueError as e:
            refused = "manifest mismatch" in str(e)
        with torch.no_grad():
            radius.fill_(START_RADIUS)
        check(refused, "a changed parameter is refused by the manifest")
    check(not tiles_root.exists(), "the tile checkpoints were removed")
    del tiled, resumed

    # -- 14. sample and voxelize on the card against the CPU ---------------------
    def host_ms(fn, repeats=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(repeats):
            out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / repeats, out

    hero_cpu = scenes.sphere_repeat_scene(device="cpu")
    st.load_leaves(hero_cpu, [q.detach().cpu().numpy() for q in st.leaves(hero)])
    points = np.random.default_rng(7).uniform(-3.0, 3.0, (SAMPLE_POINTS, 3)).astype(np.float32)
    with torch.no_grad():
        points_card = torch.from_numpy(points).cuda()
        sample_ms, sampled = host_ms(lambda: st.sample(hero, points_card))
        capped_ms, capped = host_ms(lambda: st.sample(hero, points_card, batch_size=SAMPLE_BATCH))
        small_ms, _ = host_ms(lambda: st.sample(hero, points_card, batch_size=2048), 1)
        t0 = time.perf_counter()
        sampled_cpu = st.sample(hero_cpu, torch.from_numpy(points))
        sample_cpu_s = time.perf_counter() - t0
    err = float((sampled.cpu() - sampled_cpu).abs().max())
    check(sampled.shape == (SAMPLE_POINTS, 4) and sampled.device.type == "cuda" and err <= 1e-5,
          f"sample of {SAMPLE_POINTS} points on the card vs the CPU: max abs {err:.3g} (atol 1e-5)")
    check(torch.equal(capped, sampled),
          f"sample in batches of {SAMPLE_BATCH} and a remainder equals the one-batch result bit "
          f"for bit")
    lo, hi = (-4.0, -4.0, -4.0), (4.0, 4.0, 4.0)
    with torch.no_grad():
        torch.cuda.empty_cache()  # the allocator's blocks are cut to sample's batches
        torch.cuda.reset_peak_memory_stats()
        voxel_ms, vox = host_ms(lambda: voxelize(hero, lo, hi, GRID, GRID, GRID))
        voxel_peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        vox_cpu = voxelize(hero_cpu, lo, hi, GRID, GRID, GRID)
        voxel_cpu_s = time.perf_counter() - t0
    err_v = float((vox.values.cpu() - vox_cpu.values).abs().max())
    err_c = float((vox.colors.cpu() - vox_cpu.colors).abs().max())
    check(vox.values.shape == (GRID,) * 3 and vox.colors.shape == (GRID,) * 3 + (3,)
          and vox.values.device.type == "cuda" and err_v <= 1e-5 and err_c <= 1e-5,
          f"voxelize at {GRID}^3 on the card vs the CPU: values max abs {err_v:.3g}, colours "
          f"{err_c:.3g} (atol 1e-5)")
    check(float(vox.values[0, 0, 0]) == float(np.float32(8.0) / np.float32(GRID)),
          "the volume's walls hold the outside value size.x / nx")
    smi = sh(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"])
    print(f"timing sample of {SAMPLE_POINTS} points: {sample_ms:.3f} ms on the card (host clock, "
          f"plain torch ops, one batch: the default caps a batch at 2^20 points), {capped_ms:.3f} "
          f"ms in batches of {SAMPLE_BATCH}, {small_ms:.3f} ms in batches of 2048 "
          f"({-(-SAMPLE_POINTS // 2048)} of them), {sample_cpu_s * 1e3:.1f} ms on "
          f"this host's CPU; voxelize {GRID}^3: {voxel_ms:.3f} ms on the card (peak "
          f"{voxel_peak / 1e9:.2f} GB allocated), {voxel_cpu_s * 1e3:.1f} ms on the CPU; on {smi}")
    del vox, vox_cpu, sampled, capped, sampled_cpu, points_card
    with torch.no_grad():
        radius.fill_(0.5)
    torch.cuda.synchronize()

    # -- 15. marches longer than the depths the backward keeps at once ----------
    # The replay keeps 64 depths and sweeps a longer march in segments. A plane
    # that every ray hits (a ray that misses leaves float32 by step 70), seen
    # from z = 2, through RayMarcher at 80 iterations; then rays that skim a
    # floor, nearly level, at 130 iterations: there (1 + grad d . rd) is about
    # 1, so every step of every segment carries the same share of the
    # gradient (on a ray that hits, the early steps carry almost nothing).
    wall = st.plane_xy(0.1)
    near_view = st.look_at((0.3, 0.2, 2.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    rk.LAUNCHES = rk.BWD_LAUNCHES = 0
    for depth in (False, True):
        ok, stats = grads_close(grads(wall, 40, 24, near_view, "kernel", depth, iters=80),
                                grads(wall, 40, 24, near_view, "torch", depth, iters=80), depth)
        check(ok, f"plane {'depth' if depth else 'rgb'} 40x24 at 80 iterations: backward kernel "
                  f"vs autograd of the plain path, every leaf and the view {stats}")
    check((rk.LAUNCHES, rk.BWD_LAUNCHES) == (2, 2),
          f"the 80-iteration gradients went through the image kernels (LAUNCHES, BWD_LAUNCHES) = "
          f"{(rk.LAUNCHES, rk.BWD_LAUNCHES)}")
    # The store-fed backward's ring holds 48 steps: at 80 and 130 iterations
    # it wraps, once and twice.
    rk.STORE_BWD_LAUNCHES = 0
    for iters in (80, 130):
        for depth in (False, True):
            ok, stats = grads_close(store_grads(wall, 40, 24, near_view, depth, iters),
                                    grads(wall, 40, 24, near_view, "torch", depth, iters=iters),
                                    depth)
            check(ok, f"plane {'depth' if depth else 'rgb'} 40x24 at {iters} iterations: store-fed "
                      f"backward vs autograd of the plain path, every leaf and the view {stats}")
    check(rk.STORE_BWD_LAUNCHES == 4, f"the long store-fed gradients went through the kernel "
                                      f"(STORE_BWD_LAUNCHES={rk.STORE_BWD_LAUNCHES})")
    with torch.no_grad():
        wall_target = st.RayMarcher(40, 24, wall, view=near_view, depth_iterations=80).render()
        wall.normal.copy_(torch.tensor([0.1, 0.0, 1.0]))  # tilted: the fit turns it back
    rk.BWD_LAUNCHES = 0
    long_fit = st.fit(wall, wall_target, steps=3, view=near_view, depth_iterations=80)
    check(rk.BWD_LAUNCHES == 3 and all(np.isfinite(long_fit.losses))
          and long_fit.losses[-1] < long_fit.losses[0],
          f"fit at 80 iterations: 3 steps through the kernels, losses {long_fit.losses}")
    floor = st.plane_xz(-0.2)
    rng = np.random.default_rng(17)
    n_skim = 4096
    skim_ro = np.stack([rng.uniform(-1, 1, n_skim), np.full(n_skim, 0.1), np.full(n_skim, 5.0)],
                       -1).astype(np.float32)
    skim_rd = np.stack([rng.uniform(-0.1, 0.1, n_skim), rng.uniform(-2e-3, 2e-3, n_skim),
                        -np.ones(n_skim)], -1)
    skim_rd = (skim_rd / np.linalg.norm(skim_rd, axis=-1, keepdims=True)).astype(np.float32)
    rk.RAYS_BWD_LAUNCHES = 0
    for iters in (80, 130):
        long_cfg = st.RenderConfig(8, 8, depth_iterations=iters)
        got = ray_grads(floor, skim_ro, skim_rd, long_cfg, True, True)
        ref = ray_grads(floor, skim_ro, skim_rd, long_cfg, False, True)
        ok, stats = ray_grads_close(got, ref, True)
        check(ok and float(np.abs(ref[1]).max()) > 10.0 * iters,
              f"{n_skim} rays skimming a floor at {iters} iterations, depth: ray pullback vs "
              f"autograd of plain render_depth_rays, every leaf, ro and rd {stats}; the largest "
              f"origin cotangent {float(np.abs(ref[1]).max()):.6g} grows with the steps")
    check(rk.RAYS_BWD_LAUNCHES == 2, f"the long marches went through the ray pullback kernel "
                                     f"(RAYS_BWD_LAUNCHES={rk.RAYS_BWD_LAUNCHES})")

    # -- 16. what the compiler made of the six libraries --------------------------
    from sdfkit_tpu_torch.render.cuda import sass

    roots = sum(prog.nodes[i][0] == "sqrt" for i in prog.dist_live)
    compiled = {}
    for name, klib in (("raymarch_fwd", lib), ("raymarch_bwd", bwd_lib),
                       ("raymarch_rays_fwd", rays_lib), ("raymarch_rays_bwd", rays_bwd_lib),
                       ("raymarch_fwd_store", store_lib), ("raymarch_bwd_store", store_bwd_lib)):
        report = {"registers": klib.registers.get("rgb"),
                  "resident_blocks_per_sm": klib.resident(1),
                  "instructions_per_evaluation": None}
        listing = sass.library_sass(klib.path)
        if listing is not None and "rgb" in listing:
            loops = sass.scene_loops(listing)
            per = [sass.per_evaluation(lp, roots) for lp in loops]
            # The first loop that evaluates the scene is the march (the image
            # backward's replay; the ray-batch backward's tangent march, the
            # only loop of it that walks the ray); the last one of the image
            # backward is the sweep. The store-fed build has no march.
            if name == "raymarch_rays_bwd":
                report["instructions_per_evaluation"] = {"tangent": per[0]} if per else {}
            elif name == "raymarch_bwd_store":
                report["instructions_per_evaluation"] = {"sweep": per[-1]} if per else {}
            else:
                report["instructions_per_evaluation"] = {"march": per[0]} if per else {}
            if per and name == "raymarch_bwd":
                report["instructions_per_evaluation"]["sweep"] = per[-1]
            report["kernel_instructions"] = listing["rgb"]["instructions"]
            report["loops"] = [{k: lp[k] for k in ("own", "rsq", "rcp", "fchk", "loads", "stores",
                                                   "votes")}
                               for lp in loops]
            # Innermost loops that do not evaluate the scene (the store-fed
            # build's copies into the ring), with their instructions.
            other = [lp for lp in listing["rgb"]["loops"]
                     if lp["rsq"] == 0 and lp["own"] == lp["instructions"]]
            report["other_loops"] = len(other)
            report["other_loop_instructions"] = [lp["own"] for lp in other]
            report["other_loop_stores"] = [lp["stores"] for lp in other]
        report["local_memory"] = klib.local_memory.get("rgb")
        compiled[name] = report
        print(f"compiled: {name} (RGB kernel) {report}")
    check(all(r["resident_blocks_per_sm"] > 0 for r in compiled.values()),
          "every library reports its resident blocks per SM")
    # The ray-batch backward walks the ray once: its loops that evaluate the
    # scene are the tangent march and the taps' two (no replay, no sweep),
    # and no history array takes its stack.
    rays_bwd_loops = compiled["raymarch_rays_bwd"].get("loops")
    check(rays_bwd_loops is None or len(rays_bwd_loops) == 3,
          f"the ray-batch backward's loops that evaluate the scene are the tangent march and the "
          f"taps' two: {rays_bwd_loops}")
    # The three forwards march in groups of steps, unrolled in one loop that
    # ends in the test for a warp at its fixed point (a compare and a vote),
    # then the steps that fill no group; the build with store also has the
    # loops that write a settled warp's remaining rows. The group's size is
    # read here, from the square roots of its loop: a whole number of steps,
    # the same in the three.
    marches = {name: compiled[name].get("loops") for name in
               ("raymarch_fwd", "raymarch_rays_fwd", "raymarch_fwd_store")}
    groups_seen = {name: loops[0]["rsq"] / roots for name, loops in marches.items() if loops}
    every = int(groups_seen["raymarch_fwd"]) if "raymarch_fwd" in groups_seen else None
    print(f"compiled: the forwards' march loops (groups of {every} steps with the "
          f"fixed-point test, then the steps left over): {marches}; the build with store's "
          f"other loops {compiled['raymarch_fwd_store'].get('other_loops')} "
          f"({compiled['raymarch_fwd_store'].get('other_loop_instructions')} instructions, "
          f"{compiled['raymarch_fwd_store'].get('other_loop_stores')} stores a pass)")
    check(all(loops is None or loops[0]["votes"] >= 1 for loops in marches.values())
          and all(g == every and every >= 1 for g in groups_seen.values()),
          f"each forward marches in a loop of a whole number of steps ({groups_seen}) that holds "
          f"the vote of its fixed-point test")
    # The warps' march steps: a warp of 32 rays runs groups until one ends at
    # or past its slowest ray's settled step (warp_march_steps), each forward
    # on its own history: the image forward and the build with store on the
    # store's, the ray-batch forward on its depth renders (phase 10), in the
    # frame's order and shuffled, and the mostly-sky frame on its store.
    warp_steps = rays_warp_steps = None
    warp_saved = rays_warp_saved = shuffled_saved = sky_warp_saved = None
    n_it = cfg.depth_iterations

    def saved(w):
        return float(1 - w.sum() / (w.numel() * (n_it - 1)))

    if every is not None:
        warp_steps = warp_march_steps(steps, n_it, every)
        rays_warp_steps = warp_march_steps(rays_steps, n_it, every)
        warp_saved, rays_warp_saved = saved(warp_steps), saved(rays_warp_steps)
        shuffled_saved = saved(warp_march_steps(rays_shuffled_steps, n_it, every))
        sky_warp_saved = saved(warp_march_steps(lone_steps, n_it, every))
    print(f"work: march steps saved by leaving at the fixed point in groups of {every}, "
          f"SphereRepeat {WIDTH}x{HEIGHT}x{n_it}: {warp_saved} of the image forward's warp-steps "
          f"(its store), {rays_warp_saved} of the ray-batch forward's (its own depth renders), "
          f"{shuffled_saved} of the ray-batch forward's on the shuffled rays (their own depth "
          f"renders); {sky_warp_saved} of the image forward's on the mostly-sky frame")

    # -- bounds: the least time the card could take for the same work ---------
    # render/cuda/work.py counts it: nodes of the program and the fixed work
    # around them, a ray marched to its bitwise fixed point, a sky ray not
    # shaded. The image forward's hits and settled steps are those of the
    # frame its launch was timed on (phase 5, sphere radius 0.5; phase 12's
    # store had 0.55), as bench_torch.py's roofline counts them; the
    # ray-batch forward's are its own depth renders' (phase 10) and flags.
    from sdfkit_tpu_torch.render.cuda import work
    from sdfkit_tpu_torch.sdf.compile import operation_counts

    ops_n = operation_counts(prog)
    npix = WIDTH * HEIGHT
    n = cfg.depth_iterations
    with torch.no_grad():
        hits = int((marcher.render_depth() <= cfg.far).sum())
        _, frame_store = rk.launch(store_lib, flat_params(hero).contiguous(),
                                   rk.view19(marcher.view, cfg), cfg, True, want_store=True)
        frame_steps = work.march_steps_needed(settled_steps(frame_store), n)
        del frame_store
    ray_hits = int(rays_hit.sum())
    costs = work.frame_work(prog, n, npix, hits, frame_steps, ray_hits,
                            work.march_steps_needed(rays_steps, n))
    print(f"work: {ops_n} operations per call (nodes of the program, not instructions); {hits} "
          f"of {npix} pixels hit; forward {costs['fwd'].operations:.4g} operations / "
          f"{costs['fwd'].bytes} bytes, backward {costs['bwd'].operations:.4g} / "
          f"{costs['bwd'].bytes}")
    # Both image kernels against the rate at which the card starts
    # instructions: one per lane and cycle, 128 lanes an SM, at the highest SM
    # clock. Every count is read from this build's SASS: a loop's instructions
    # times the passes this frame gives it are the least a launch executes, and
    # every instruction outside the innermost loops once a pixel more is the
    # most (none of them runs more than once a pixel, the slow paths of a
    # square root or a division aside; a sky pixel skips many, so the most can
    # come out above 1).
    tangent_ops = ops_n["dist_unit"] + work.UNIT_OPS + 2 * ops_n["dist_slots"]
    march_per = (compiled["raymarch_fwd"]["instructions_per_evaluation"] or {}).get("march")
    clock = sh(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"])
    issue_share = {}  # the forwards' share of the instruction rate, where SASS says it
    if march_per is not None and clock.strip().isdigit():
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        instruction_rate = work.instruction_rate(sms, float(clock))

        def rate_shares(name, in_loops, ms):
            """What kernel `name`, which executed `in_loops` instructions inside
            its innermost loops in `ms`, reaches of the instruction rate at the
            least, and at the most where every other loop's passes are known."""
            outside = (compiled[name]["kernel_instructions"]
                       - sum(lp["own"] for lp in compiled[name]["loops"]))
            text = f"{in_loops / (ms * 1e-3) / instruction_rate:.3f} of the instruction rate"
            if compiled[name]["other_loops"] == 0:
                most = (in_loops + npix * outside) / (ms * 1e-3) / instruction_rate
                text += (f", and {most:.3f} with the kernel's other {outside} instructions "
                         f"once a pixel")
            return text

        # The three forwards: a warp runs the march's groups (the first loop,
        # its vote after each group) until a group ends at or past its
        # slowest lane's settled step, and otherwise all whole groups and the
        # steps left over (the second loop), as warp_march_steps gives from
        # each forward's own history, 32 lanes a pass; the build with store
        # then writes the warp's remaining rows (n minus its steps) in loops
        # of stores alone, counted at their fewest instructions a row.
        forwards = (("raymarch_fwd", "the image forward", handoff_ms["fwd"], warp_steps),
                    ("raymarch_rays_fwd", "the ray-batch forward", rays_ms, rays_warp_steps),
                    ("raymarch_fwd_store", "the forward with store", handoff_ms["fwd_store"],
                     warp_steps))
        for name, what, ms, w_steps in forwards:
            counted = work.forward_loop_instructions(compiled[name].get("loops", []), roots,
                                                     every, w_steps, n)
            if counted is None:
                continue
            in_loops, fixed = counted["in_loops"], counted["fixed"]
            per, rest_per = counted["per_step"], counted["rest_per_step"]
            warp_passes, n_warps = counted["warp_steps"], counted["warps"]
            text = (f"{per:.1f} instructions per march step in groups of {every} (the vote "
                    f"included), {rest_per:.1f} per step left over")
            if name == "raymarch_fwd_store":
                rows_per = [own / st_ for own, st_ in
                            zip(compiled[name]["other_loop_instructions"],
                                compiled[name]["other_loop_stores"]) if st_ > 0]
                if rows_per:
                    in_loops += 32 * (n_warps * n - warp_passes) * min(rows_per)
                    fixed += 32 * n_warps * min(rows_per)
                    text += f", and at least {min(rows_per):.1f} per row written after it"
            issue_share[name] = in_loops / (ms * 1e-3) / instruction_rate
            print(f"work: {what} executes {text}, for {ops_n['dist']} counted operations a step "
                  f"({per / ops_n['dist']:.2f} per operation); its warps run "
                  f"{warp_passes} march steps of {n_warps * (n - 1)} "
                  f"({1 - warp_passes / (n_warps * (n - 1)):.4f} saved): "
                  f"{in_loops:.4g} thread instructions in its loops (fixed work {fixed:.4g}) in "
                  f"{ms:.4f} ms; {sms} SMs start {instruction_rate:.4g} per second at "
                  f"{clock.strip()} MHz: {rate_shares(name, in_loops, ms)}")
        # The backward's loops in address order (the replay, the taps'
        # forward pass and unit gradients, the sweep), then the pair that
        # serves a march of more than 64 steps and does not run here.
        bwd_counted = work.backward_loop_instructions(compiled["raymarch_bwd"].get("loops", []),
                                                      roots, npix, hits, n)
        if bwd_counted is not None:
            in_loops = bwd_counted["in_loops"]
            print(f"work: the backward executes {bwd_counted['per_replay_step']:.1f} "
                  f"instructions per replayed step, {bwd_counted['per_tap'][0]:.1f} / "
                  f"{bwd_counted['per_tap'][1]:.1f} per tap (forward / unit gradient) and "
                  f"{bwd_counted['per_sweep_step']:.1f} per sweep step for "
                  f"{ops_n['dist_unit']} + {work.UNIT_OPS + ops_n['dist_slots']} counted "
                  f"operations; its loops are {in_loops:.4g} thread instructions in "
                  f"{bwd_launch_ms:.4f} ms: {rate_shares('raymarch_bwd', in_loops, bwd_launch_ms)}")
        # The ray-batch backward: the tangent march, then the taps' two
        # loops, on the rays the forward hit (the flags skip the others).
        tangent_loops = compiled["raymarch_rays_bwd"].get("loops", [])
        if len(tangent_loops) == 3:
            tangent, tap_fwd, tap_unit = tangent_loops
            per_step = tangent["own"] * roots / tangent["rsq"]
            in_loops = ray_hits * (3 * tap_fwd["own"] + 3 * tap_unit["own"] + (n - 1) * per_step)
            print(f"work: the ray-batch backward executes {per_step:.1f} instructions per tangent "
                  f"step for {tangent_ops} counted operations; on the {ray_hits} rays the "
                  f"forward hit its loops are {in_loops:.4g} thread instructions in "
                  f"{rays_bwd_ms:.4f} ms: {rate_shares('raymarch_rays_bwd', in_loops, rays_bwd_ms)}")
        # The store-fed backward: the taps' two loops and the sweep, and the
        # copies into the ring (n - 1 passes of its copy loops a hit pixel).
        store_loops = compiled["raymarch_bwd_store"].get("loops", [])
        copies = compiled["raymarch_bwd_store"].get("other_loop_instructions", [])
        if len(store_loops) == 3 and copies:
            tap_fwd, tap_unit, sweep = store_loops
            per_step = sweep["own"] * roots / sweep["rsq"]
            per_copy = sum(copies) / len(copies)
            in_loops = hits * (3 * tap_fwd["own"] + 3 * tap_unit["own"]
                               + (n - 1) * (per_step + per_copy))
            ms = handoff_ms["bwd_store"]
            print(f"work: the store-fed backward executes {per_step:.1f} instructions per sweep "
                  f"step and {per_copy:.1f} per copy into the ring; its loops are "
                  f"{in_loops:.4g} thread instructions in {ms:.4f} ms: "
                  f"{in_loops / (ms * 1e-3) / instruction_rate:.3f} of the instruction rate")

    fwd_bound, fwd_by = costs["fwd"].bound()
    fwd_fixed_bound, _ = costs["fwd_fixed"].bound()
    bwd_bound, bwd_by = costs["bwd"].bound()
    rays_bound, rays_by = costs["rays_fwd"].bound()
    rays_fixed_bound, _ = costs["rays_fwd_fixed"].bound()
    rays_bwd_bound, rays_bwd_by = costs["rays_bwd"].bound()
    # The ray-batch pullback's work as the replay and the sweep did it (the
    # bound this kernel had before the tangent march), for comparison.
    replay_form_bound, _ = costs["rays_bwd_as_replay"].bound()
    store_bound, store_by = costs["fwd_store"].bound()
    store_fixed_bound, _ = costs["fwd_store_fixed"].bound()
    store_bwd_bound, store_bwd_by = costs["bwd_store"].bound()
    print(f"work: the forwards' bounds as the work this frame needs (fixed work beside it): "
          f"image {costs['fwd'].operations:.4g} operations, {fwd_bound:.4f} ms "
          f"({costs['fwd_fixed'].operations:.4g}, {fwd_fixed_bound:.4f} ms); ray-batch "
          f"{costs['rays_fwd'].operations:.4g}, {rays_bound:.4f} ms "
          f"({costs['rays_fwd_fixed'].operations:.4g}, {rays_fixed_bound:.4f} ms); "
          f"with store {store_bound:.4f} ms by {store_by} ({store_fixed_bound:.4f} ms)")
    print(f"work: ray-batch forward {costs['rays_fwd'].operations:.4g} operations / "
          f"{costs['rays_fwd'].bytes} bytes, ray-batch backward {costs['rays_bwd'].operations:.4g} / "
          f"{costs['rays_bwd'].bytes} (as a replay and a sweep "
          f"{costs['rays_bwd_as_replay'].operations:.4g}, bound {replay_form_bound:.4f} ms); "
          f"forward with store {costs['fwd_store'].operations:.4g} / {costs['fwd_store'].bytes}, "
          f"backward fed the store {costs['bwd_store'].operations:.4g} / "
          f"{costs['bwd_store'].bytes}")

    # -- 17. meshing; 18. registration -----------------------------------------
    t_mesh = time.perf_counter()
    mesh_line = phase_mesh(st, smi)
    t_icp = time.perf_counter()
    icp_line = phase_icp(st, smi)
    # -- 19. the sharded paths over 4 ranks on this card ---------------------------
    t_sharded = time.perf_counter()
    sharded_line = phase_sharded(st, smi)
    # -- 20. the viewer; 21. the scaling harness ------------------------------------
    t_view = time.perf_counter()
    view_line = phase_view(st, smi)
    t_scaling = time.perf_counter()
    scaling_line = phase_scaling(smi, costs["fwd_fixed"].operations)
    # -- 22. the benchmark -------------------------------------------------------------
    t_bench = time.perf_counter()
    phase_bench()
    # -- 23. the sharded paths on every card over NCCL ----------------------------------
    t_cards = time.perf_counter()
    cards_result = phase_cards(st, smi)
    # -- 24. the fitting-sized scene: 200 spheres, 1,400 slots, the large tier ---
    t_grid = time.perf_counter()
    grid_line = phase_union_grid(st, smi, grid_builder)
    print(f"clock: phases 1-16 took {t_mesh - t_start:.1f} s (the kernels' builds included), "
          f"phase 17 {t_icp - t_mesh:.1f} s, phase 18 {t_sharded - t_icp:.1f} s, phase 19 "
          f"{t_view - t_sharded:.1f} s, phase 20 {t_scaling - t_view:.1f} s, phase 21 "
          f"{t_bench - t_scaling:.1f} s, phase 22 {t_cards - t_bench:.1f} s, phase 23 "
          f"{t_grid - t_cards:.1f} s, phase 24 {time.perf_counter() - t_grid:.1f} s (of which "
          f"{grid_line.get('waited_for_builds_s', 0.0):.1f} s waiting for its builds)")

    if FAILURES:
        print(f"chip_smoke: {len(FAILURES)} check(s) failed:", file=sys.stderr)
        for f in FAILURES:
            print("  " + f, file=sys.stderr)
        return 1
    print(json.dumps({"mesh": mesh_line}))
    print(json.dumps({"icp": icp_line}))
    print(json.dumps({"sharded": sharded_line}))
    print(json.dumps({"view": view_line}))
    print(json.dumps({"scaling": scaling_line}))
    print(json.dumps({"sharded_cards": cards_result}))
    print(json.dumps({"union_grid": grid_line}))
    print(smi)
    def grid_kernel(key, launches, err):
        """The union grid's numbers of one kernel (phase 24): its launches on
        the phase's path as its counters read them, and ``err``, the phase's
        readings of it against its reference, by name."""
        return {"launches": launches, "ms": grid_line["ms"][key],
                "bound_ms": grid_line["bound_ms"][key], "bound_by": grid_line["bound_by"][key],
                **err, "build_s": grid_line["builds"][key]["build_s"],
                "registers": grid_line["builds"][key]["registers"],
                "local_memory": grid_line["builds"][key]["local_memory"]}

    gl = grid_line["launches"]
    grid_grad_err = {"leaf_err_of_largest_entry_vs_plain":
                     grid_line["grad_1080p_subset"]["leaf_err_of_largest"]}
    print(json.dumps({"kernels": [
        {"name": "raymarch_fwd", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": REPLACES, "launches": launches, "launches_in_fit": fwd_launches,
         "launches_sharded": sharded_launches(sharded_line, 0),
         "launches_sharded_cards": cards_launches(cards_result, 0),
         "launches_view": {"frames": view_line["launches"], "cli": view_line["cli_launches"]},
         "launches_scaling_per_frame": {p["devices"]: p["launches_per_frame"]
                                        for p in scaling_line["points"]},
         "max_abs_err": full_stats["max"], "ms": launch_ms, "frame_ms": kernel_ms,
         "plain_ms": plain_ms, "bound_ms": fwd_bound, "bound_by": fwd_by, "library_ms": None,
         "bound_ms_fixed_work": fwd_fixed_bound, "issue_share": issue_share.get("raymarch_fwd"),
         "warp_steps_saved": warp_saved, "mostly_sky_ms": sky_fwd_ms,
         "union_grid": grid_kernel("fwd", gl["fwd"] + gl["grad_1080p"][0] + gl["fit"][0],
                                   {"max_abs_err_vs_plain": grid_line["frame_vs_plain"]["max"]}),
         **compiled["raymarch_fwd"]},
        {"name": "raymarch_bwd", "route": "cuda", "source": BWD_SOURCE,
         "replaces": BWD_REPLACES, "launches": bwd_launches,
         "launches_sharded": sharded_launches(sharded_line, 1),
         "launches_sharded_cards": cards_launches(cards_result, 1), "max_abs_err": bwd_err,
         "ms": bwd_launch_ms, "plain_ms": plain_bwd_ms, "plain_shape": [pw, ph],
         "bound_ms": bwd_bound, "bound_by": bwd_by, "library_ms": None,
         "mostly_sky_ms": sky_bwd_ms,
         "union_grid": grid_kernel("bwd", gl["grad_1080p"][1] + gl["fit"][1], grid_grad_err),
         **compiled["raymarch_bwd"]},
        {"name": "raymarch_rays_fwd", "route": "cuda", "source": RAYS_SOURCE,
         "replaces": RAYS_REPLACES, "launches": rays_launches, "max_abs_err": rays_stats["max"],
         "ms": rays_ms, "plain_ms": rays_plain_ms, "bound_ms": rays_bound, "bound_by": rays_by,
         "library_ms": None, "bound_ms_fixed_work": rays_fixed_bound,
         "issue_share": issue_share.get("raymarch_rays_fwd"),
         "warp_steps_saved": rays_warp_saved,
         "mostly_sky_ms": sky_rays_ms, "shuffled_ms": rays_shuffled_ms,
         "shuffled_warp_steps_saved": shuffled_saved,
         "union_grid": grid_kernel(
             "rays_fwd", gl["rays_1080p"][0] + gl["rays_64x36"][0],
             {"max_abs_err_vs_plain": grid_line["rays_subset_vs_plain"]["max"]}),
         **compiled["raymarch_rays_fwd"]},
        {"name": "raymarch_rays_bwd", "route": "cuda", "source": RAYS_BWD_SOURCE,
         "replaces": RAYS_BWD_REPLACES, "launches": rays_step_launches[1],
         "max_abs_err": rays_bwd_err, "max_err_of_largest_entry": rays_bwd_share,
         "full_size_leaf_err_of_largest_entry": rays_full_err,
         "full_size_ray_cotangents": rays_full_stats,
         "ms": rays_bwd_ms, "ms_without_hit_flags": rays_bwd_unflagged_ms,
         "mostly_sky_ms": sky_rays_bwd_ms, "plain_ms": plain_bwd_ms,
         "plain_shape": [pw, ph], "bound_ms": rays_bwd_bound, "bound_by": rays_bwd_by,
         "bound_ms_as_replay_and_sweep": replay_form_bound,
         "rays_whose_march_ends_elsewhere": rays_depths_apart,
         "library_ms": None,
         "union_grid": grid_kernel(
             "rays_bwd", gl["rays_1080p"][1] + gl["rays_64x36"][1],
             {"leaf_err_of_largest_entry_vs_plain": grid_line["rays_64x36_leaf_err_of_largest"]}),
         **compiled["raymarch_rays_bwd"]},
        {"name": "raymarch_fwd_store", "route": "cuda", "source": KERNEL_SOURCE,
         "replaces": STORE_REPLACES, "launches": store_launches[0], "max_abs_err": store_err,
         "full_size_vs_plain": store_full_stats,
         "ms": handoff_ms["fwd_store"], "plain_ms": history_ms, "bound_ms": store_bound,
         "bound_by": store_by, "library_ms": None, "bound_ms_fixed_work": store_fixed_bound,
         "issue_share": issue_share.get("raymarch_fwd_store"), "warp_steps_saved": warp_saved,
         "mostly_sky_ms": sky_store_ms,
         "union_grid": grid_kernel(
             "fwd_store", gl["store"][0],
             {"max_abs_err_vs_plain": grid_line["store_frame_vs_plain"]["max"]}),
         **compiled["raymarch_fwd_store"]},
        {"name": "raymarch_bwd_store", "route": "cuda", "source": BWD_SOURCE,
         "replaces": STORE_BWD_REPLACES, "launches": store_launches[1],
         "max_abs_err": store_bwd_err, "max_abs_err_vs_replay": store_vs_replay,
         "ms": handoff_ms["bwd_store"], "mostly_sky_ms": sky_store_bwd_ms,
         "plain_ms": plain_bwd_ms,
         "plain_shape": [pw, ph], "bound_ms": store_bwd_bound, "bound_by": store_bwd_by,
         "library_ms": None,
         "union_grid": grid_kernel(
             "bwd_store", gl["store"][1],
             {"err_of_largest_entry_vs_replay": grid_line["store_vs_replay"]}),
         **compiled["raymarch_bwd_store"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(build_union_grid() if sys.argv[1:] == ["--build-union-grid"] else main())
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
                child.wait()
