#!/usr/bin/env python3
"""Benchmark of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100),
section for section the counterpart of ``bench.py``.

    python3 bench_torch.py                  # make perf-torch
    python3 bench_torch.py --profile DIR    # make trace-torch: a torch.profiler
                                            # Chrome trace, DIR/trace.json.gz

It measures SphereRepeat (``sdfkit_tpu_torch.scenes.sphere_repeat_scene``, the
reference's Perf scene) seen from bench.py's view, ``look_at((-2, 2, 4),
(0, 0, 0), (0, 1, 0))``, at 1920x1080 with 40 march iterations, and prints
one JSON line per section, in bench.py's order, then the headline last:

    {"metric": "sphere_repeat_render_1920x1080", "value": <Mrays/s>,
     "unit": "Mrays/s", "vs_baseline": <kernel path over the plain path>,
     "extra": {...}}

The sections: ``render`` (frames through ``RayMarcher.render`` against the
plain path, and the image-forward launch alone), ``roofline`` (the kernels'
work and bounds, ``render/cuda/work.py``), ``occupancy`` (the profiler's
device time per kernel, and the forwards' share of the card's instruction
rate from SASS), ``fused_drift`` (kernel against plain per pixel), ``4k``,
``voxels``, ``mesh`` and ``mesh_512`` (``SdfExpr.to_mesh`` beside the
sequential C++ baseline), ``grad`` (a gradient step through the image
kernels against autograd of the plain path, and their parity), ``icp``
and ``scaling`` (4K row bands alone on the card, and
``tools/torch_scaling.py`` over 1, 2 and 4 ``gloo`` ranks on the card and,
on a machine of several cards, over 1, 2 and 4 cards under NCCL).

Timing: launches alone with CUDA events, each queued behind a sleep on the
card so that the host's work to start it is not timed; entry points (a
frame, a gradient step, ``to_mesh``, a registration) on the host clock
between two ``torch.cuda.synchronize()``. Three warm-ups, ten timed samples,
each reported as its median and p90 with the count; kernel against plain
in turns (plain, kernel, kernel, plain). Every line names the card and its
power limit.

It runs on the card and refuses to run without one. It exits 1 when a check
fails (after every section has printed). It writes nothing but the kernels'
builds (``sdfkit_tpu_torch/_build/``) and, with ``--profile``, the trace.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch import native, scenes
from sdfkit_tpu_torch.mesh import marching_cubes as mc
from sdfkit_tpu_torch.registration import icp
from sdfkit_tpu_torch.render import raymarch
from sdfkit_tpu_torch.render.cuda import build, sass, work
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params, operation_counts
from sdfkit_tpu_torch.utils.camera import inv_view_proj

ROOT = pathlib.Path(__file__).resolve().parent
WIDTH, HEIGHT = 1920, 1080
WIDTH_4K, HEIGHT_4K = 3840, 2160
EYE = (-2.0, 2.0, 4.0)
WARMUP, REPS = 3, 10
SLEEP_CYCLES = 40_000_000  # about 20 ms at 1980 MHz, ahead of each launch timed on the card
DRIFT_SIZES = ((192, 108), (WIDTH, HEIGHT))
VOXEL_GRID = 256
BOUNDS = ((-2.0,) * 3, (2.0,) * 3)
# SphereRepeat over [-2, 2]^3 meshes to these (the JAX package's run, BENCH_r05.json).
MESH_VERTICES = {256: 300_152, 512: 1_215_992}
ICP_POINTS = (10_000, 100_000)
ICP_TOL = 1e-4
SCALING_COUNTS = (1, 2, 4, 8)
AUDIT_RANKS = (1, 2, 4)
AUDIT_TIMEOUT = 600
START_RADIUS = 0.55  # the gradient parity's scene; its target frame has radius 0.5
GRAD_PARITY_BOUND = 5e-2  # ROADMAP C.3, of the largest entry, at 40 iterations


# -- clocks ---------------------------------------------------------------------

def sync() -> None:
    torch.cuda.synchronize()


def stats(samples) -> dict:
    """The median, 90th percentile and count of a list of samples."""
    a = np.asarray(samples, np.float64)
    return {"median": float(np.median(a)), "p90": float(np.percentile(a, 90)), "n": int(a.size)}


def host_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> list[float]:
    """Milliseconds of ``reps`` calls of ``fn`` on the host clock, each
    between two synchronises of the card, after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def device_ms(fn, warmup: int = WARMUP, reps: int = REPS) -> list[float]:
    """Milliseconds of ``reps`` calls of ``fn`` on the card: each between two
    CUDA events, queued behind a sleep so that the host's work to start it
    is not timed. Raises where the host took longer to queue a call than the
    sleep lasted."""
    for _ in range(warmup):
        fn()
    out = []
    for _ in range(reps):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        sync()
        sleep_start = torch.cuda.Event(enable_timing=True)
        sleep_start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        t0 = time.perf_counter()
        start.record()
        fn()
        stop.record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        sync()
        if queued_ms >= sleep_start.elapsed_time(start):
            raise RuntimeError(f"the host took {queued_ms:.3f} ms to queue a timed call, longer "
                               f"than the sleep ahead of it")
        out.append(start.elapsed_time(stop))
    return out


def in_turns(plain, kernel, clock) -> tuple[list[float], list[float]]:
    """(plain samples, kernel samples) of ``clock`` taken in turns: plain,
    kernel, kernel, plain."""
    p, k = [], []
    for side in (p, k, k, p):
        side.extend(clock(plain if side is p else kernel))
    return p, k


class Counted:
    """``fn`` that counts its calls, beside the kernels' launch counters."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0
        self.launches0 = (rk.LAUNCHES, rk.BWD_LAUNCHES)

    def __call__(self):
        self.calls += 1
        return self.fn()

    def per_call(self) -> list[float]:
        """Image-forward and image-backward launches per call so far."""
        return [(rk.LAUNCHES - self.launches0[0]) / self.calls,
                (rk.BWD_LAUNCHES - self.launches0[1]) / self.calls]


# -- the scene and its frames ------------------------------------------------------

def bench_view() -> torch.Tensor:
    return st.look_at(EYE, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))


def bench_marcher(width: int, height: int, backend: str = "auto") -> st.RayMarcher:
    """SphereRepeat from bench.py's view: the frame every section renders."""
    return st.RayMarcher(width, height, scenes.sphere_repeat_scene(), view=bench_view(),
                         backend=backend)


def distributional(a: np.ndarray, b: np.ndarray) -> bool:
    """The contract of tests/test_goldens.py:66-68 for RGB from two programs:
    median |diff| <= 5e-3, at most 0.5% of pixels off by more than 1e-2 and
    at most 0.1% by more than 5e-2."""
    d = np.abs(a - b)
    px = d.max(axis=-1)
    return bool(np.median(d) <= 5e-3 and (px > 1e-2).sum() <= 0.005 * px.size
                and (px > 5e-2).sum() <= 0.001 * px.size)


def zero_grads(scene) -> None:
    for q in st.leaves(scene):
        q.grad = None


def gradient_step(marcher) -> None:
    """The benchmark's gradient step: an image-sum loss, backward."""
    zero_grads(marcher.sdf)
    marcher.render().sum().backward()


def frame_history(scene, view, cfg) -> tuple[int, torch.Tensor]:
    """(pixels the kernels' depth render hits, each ray's settled step on
    the image forward's own depth history): what the frame needs, as
    chip_smoke.py phase 12 reads it (one launch of the forward that writes
    the history, outside every timed loop)."""
    program = compile_scene(scene)
    with torch.no_grad():
        depth = st.RayMarcher(cfg.width, cfg.height, scene, view=view).render_depth()
        _, store = rk.launch(build.load(program, store=True), flat_params(scene).contiguous(),
                             rk.view19(view, cfg), cfg, True, want_store=True)
    return int((depth <= cfg.far).sum()), raymarch.settled_steps(store)


# -- the sections, in bench.py's order ----------------------------------------------

def bench_render(width: int = WIDTH, height: int = HEIGHT) -> dict:
    """Frames through ``RayMarcher(...).render()`` (``backend="auto"``: the
    image forward) against the plain path (``render_image_torch``) in turns
    on the host clock, and the image-forward launch alone with CUDA events.
    ``value`` is the entry point's median Mrays/s; ``vs_baseline`` the plain
    path's median frame over the kernel path's, on the same card."""
    marcher = bench_marcher(width, height)
    scene, view, cfg = marcher.sdf, marcher.view, marcher.config
    program = compile_scene(scene)
    builds = build.BUILDS
    with torch.no_grad():
        sync()
        t0 = time.perf_counter()
        frame = marcher.render()
        sync()
        first_s = time.perf_counter() - t0
        lib = build.load(program)
        kernel = Counted(marcher.render)
        plain_ms, kernel_ms = in_turns(
            lambda: raymarch.render_image_torch(scene, view, cfg), kernel, host_ms)
        per_frame = kernel.per_call()
        params = flat_params(scene).contiguous()
        v19 = rk.view19(view, cfg)
        launch_ms = device_ms(lambda: rk.launch(lib, params, v19, cfg, True))
    npix = width * height
    entry, plain, launch = stats(kernel_ms), stats(plain_ms), stats(launch_ms)
    mrays = npix / entry["median"] / 1e3
    frame = frame.cpu().numpy()
    return {
        "metric": f"sphere_repeat_render_{width}x{height}",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": plain["median"] / entry["median"],
        "extra": {
            "render_ms": entry["median"],
            "backend": marcher.backend,
            "render_ms_kernel": entry,
            "render_ms_plain": plain,
            "plain_Mrays_per_s": npix / plain["median"] / 1e3,
            "launch_ms": launch,
            "launch_Mrays_per_s": npix / launch["median"] / 1e3,
            "launches_per_timed_frame": per_frame,
            "build_s": {"nvcc": getattr(lib, "build_seconds", None), "first_frame": first_s,
                        "nvcc_runs": build.BUILDS - builds},
        },
        "checks": {
            "render: RayMarcher(auto) took the kernels": marcher.backend == "kernel",
            "render: one image-forward launch and no backward per timed frame":
                per_frame == [1.0, 0.0],
            "render: the frame is finite, (H, W, 3)":
                frame.shape == (height, width, 3) and bool(np.isfinite(frame).all()),
        },
    }


def bench_roofline(render: dict, width: int = WIDTH, height: int = HEIGHT) -> dict:
    """The image kernels' work at this frame (``render/cuda/work.py``: nodes
    of the compiled program and the fixed work around them) and their bounds
    against 67 TFLOP/s float32 and 3.35 TB/s: the forward as the frame needs
    it (each ray to its bitwise fixed point, only hits shaded) and as fixed
    work, the backward, and the forward's share of its bound."""
    scene, view = scenes.sphere_repeat_scene(), bench_view()
    cfg = st.RenderConfig(width, height)
    program = compile_scene(scene)
    n, npix = cfg.depth_iterations, width * height
    hits, settled = frame_history(scene, view, cfg)
    steps = work.march_steps_needed(settled, n)
    costs = work.frame_work(program, n, npix, hits, steps)
    fwd, fixed, bwd = costs["fwd"], costs["fwd_fixed"], costs["bwd"]
    (fwd_ms, fwd_by), (fixed_ms, _), (bwd_ms, bwd_by) = fwd.bound(), fixed.bound(), bwd.bound()
    launch = render["extra"]["launch_ms"]["median"]
    frame = render["extra"]["render_ms"]
    return {
        "operation_counts": operation_counts(program),
        "pixels": npix,
        "hits": hits,
        "march_steps": steps,
        "march_steps_fixed": npix * (n - 1),
        "frame_gops": fwd.operations / 1e9,
        "frame_gops_fixed": fixed.operations / 1e9,
        "hbm_floor_mb": fwd.bytes / 1e6,
        "lightspeed_ms_compute": fwd.operations / work.PEAK_FP32_OPS * 1e3,
        "lightspeed_ms_memory": fwd.bytes / work.PEAK_BYTES * 1e3,
        "lightspeed_ms": fwd_ms,
        "bound": fwd_by,
        "lightspeed_ms_fixed": fixed_ms,
        "bwd_gops": bwd.operations / 1e9,
        "bwd_lightspeed_ms": bwd_ms,
        "bwd_bound": bwd_by,
        "lightspeed_ms_grad": fwd_ms + bwd_ms,
        "census_ops_per_ray": fwd.operations / npix,
        "census_bwd_ops_per_ray": bwd.operations / npix,
        "achieved_tops_launch": fwd.operations / launch / 1e9,
        "bound_share_launch_pct": 100.0 * fwd_ms / launch,
        "bound_share_launch_fixed_pct": 100.0 * fixed_ms / launch,
        "bound_share_frame_pct": 100.0 * fwd_ms / frame,
        "peak_fp32_ops_per_s": work.PEAK_FP32_OPS,
        "peak_bytes_per_s": work.PEAK_BYTES,
        "march_steps_from": "the image forward's depth history",
        "checks": {
            "roofline: some rays hit and settle":
                0 < hits <= npix and npix <= steps < npix * (n - 1),
        },
    }


KERNELS_LISTED = 6  # the kernels of a profiled loop listed by name, the longest first


def _kernel_events(prof) -> dict:
    """{kernel name: [ms of each launch]} of the CUDA kernels in a trace,
    the names cut at their argument list."""
    from torch.autograd import DeviceType

    out: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = e.name.removeprefix("void ").split("(")[0][:80]
            out.setdefault(name, []).append(e.time_range.elapsed_us() / 1e3)
    return out


def _issue_shares(program, settled, hits, cfg, fwd_ms, bwd_ms) -> dict:
    """The image kernels' share of the rate at which the card starts
    instructions, from the SASS of their libraries (``render/cuda/sass.py``,
    as chip_smoke.py phase 16 reads it); empty where the toolkit has no
    ``cuobjdump`` or ``nvidia-smi`` gives no clock."""
    clock = _smi("clocks.max.sm", units=False)
    listings = {name: sass.library_sass(lib.path) for name, lib in
                (("fwd", build.load(program)), ("bwd", build.load_bwd(program)))}
    if not clock or any(v is None or "rgb" not in v for v in listings.values()):
        return {}
    roots = sum(program.nodes[i][0] == "sqrt" for i in program.dist_live)
    rate = work.instruction_rate(torch.cuda.get_device_properties(0).multi_processor_count,
                                 float(clock))
    n, npix = cfg.depth_iterations, cfg.width * cfg.height
    out = {"instruction_rate_per_s": rate, "sm_clock_mhz": float(clock)}
    loops = sass.scene_loops(listings["fwd"])
    if loops and roots:
        every = int(loops[0]["rsq"] // roots)
        counted = work.forward_loop_instructions(
            loops, roots, every, raymarch.warp_march_steps(settled, n, every), n)
        if counted is not None:
            out["issue_share_fwd"] = counted["in_loops"] / (fwd_ms * 1e-3) / rate
            out["instructions_per_march_step"] = counted["per_step"]
    counted = work.backward_loop_instructions(sass.scene_loops(listings["bwd"]), roots, npix,
                                              hits, n)
    if counted is not None:
        out["issue_share_bwd"] = counted["in_loops"] / (bwd_ms * 1e-3) / rate
    return out


def bench_occupancy(roofline: dict, width: int = WIDTH, height: int = HEIGHT) -> dict:
    """``torch.profiler``'s device time per kernel over ten frames and ten
    gradient steps through the image kernels, each kernel's bound over its
    device time, the card's busy share of the profiled window, and the
    kernels' share of the instruction rate (SASS)."""
    from torch.profiler import ProfilerActivity, profile

    scene, view = scenes.sphere_repeat_scene(), bench_view()
    marcher = st.RayMarcher(width, height, scene, view=view)
    program = compile_scene(scene)

    def frame():
        with torch.no_grad():
            marcher.render()

    out, traced = {}, {}
    for name, fn in (("fwd", frame), ("step", lambda: gradient_step(marcher))):
        for _ in range(WARMUP):
            fn()
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                fn()
            sync()
            wall = (time.perf_counter() - t0) * 1e3
        traced[name] = kernels = _kernel_events(prof)
        busy = sum(sum(v) for v in kernels.values())
        out[f"device_busy_ms_per_{name}"] = busy / REPS
        out[f"idle_share_{name}"] = 1.0 - busy / wall if busy > 0 else None
        longest = sorted(kernels.items(), key=lambda kv: -sum(kv[1]))[:KERNELS_LISTED]
        out[f"kernels_{name}"] = {k: stats(v) for k, v in longest}
    fwd = [stats(v) for k, v in traced["fwd"].items() if k.startswith("raymarch_fwd_kernel")]
    pull = [stats(v) for k, v in traced["step"].items() if k.startswith("raymarch_bwd_kernel")]
    reduce = [stats(v) for k, v in traced["step"].items()
              if k.startswith("reduce_partials_kernel")]
    checks = {"occupancy: the profiler shows the image forward and backward on the card":
              bool(fwd and pull and reduce)}
    if fwd and pull and reduce:
        fwd_ms = fwd[0]["median"]
        bwd_ms = pull[0]["median"] + reduce[0]["median"]
        out["kernel_device_ms_fwd"] = fwd_ms
        out["kernel_device_ms_bwd"] = bwd_ms
        out["kernel_device_ms_stats"] = {"fwd": fwd[0], "bwd_pullback": pull[0],
                                         "bwd_reduction": reduce[0]}
        out["bound_share_device_pct_fwd"] = 100.0 * roofline["lightspeed_ms"] / fwd_ms
        out["bound_share_device_fixed_pct_fwd"] = 100.0 * roofline["lightspeed_ms_fixed"] / fwd_ms
        out["bound_share_device_pct_bwd"] = 100.0 * roofline["bwd_lightspeed_ms"] / bwd_ms
        cfg = st.RenderConfig(width, height)
        hits, settled = frame_history(scene, view, cfg)
        out.update(_issue_shares(program, settled, hits, cfg, fwd_ms, bwd_ms))
    out["occupancy_trace_frames"] = REPS
    out["checks"] = checks
    return out


def bench_fused_drift(sizes=DRIFT_SIZES) -> dict:
    """Kernel against plain per pixel (the worst channel of each): the
    pixels beyond 1e-3, 1e-2 and 5e-2, max and median, each frame held to
    the distributional contract."""
    scene, view = scenes.sphere_repeat_scene(), bench_view()
    out, checks = {}, {}
    for w, h in sizes:
        with torch.no_grad():
            k = st.RayMarcher(w, h, scene, view=view).render().cpu().numpy()
            p = st.RayMarcher(w, h, scene, view=view, backend="torch").render().cpu().numpy()
        d = np.abs(k - p)
        px = d.max(axis=-1)
        out[f"fused_drift_{w}x{h}"] = {
            "max": float(d.max()),
            "median": float(np.median(d)),
            "px_gt_1e-3": int((px > 1e-3).sum()),
            "px_gt_1e-2": int((px > 1e-2).sum()),
            "px_gt_5e-2": int((px > 5e-2).sum()),
            "px_total": int(px.size),
        }
        checks[f"fused_drift: {w}x{h} kernel against plain within the distributional contract"] = \
            distributional(k, p)
    return {"fused_drift": out, "checks": checks}


def bench_4k(width: int = WIDTH_4K, height: int = HEIGHT_4K) -> dict:
    """A frame and a gradient step at 3840x2160 through the two image
    kernels (host clock), and each kernel's launch alone (CUDA events)."""
    scene, view = scenes.sphere_repeat_scene(), bench_view()
    marcher = st.RayMarcher(width, height, scene, view=view)
    cfg, program = marcher.config, compile_scene(scene)
    npix = width * height
    with torch.no_grad():
        frame = Counted(marcher.render)
        frame_ms = host_ms(frame)
        per_frame = frame.per_call()
    step = Counted(lambda: gradient_step(marcher))
    step_ms = host_ms(step)
    per_step = step.per_call()
    zero_grads(scene)
    with torch.no_grad():
        lib, bwd_lib = build.load(program), build.load_bwd(program)
        params = flat_params(scene).contiguous()
        v19 = rk.view19(view, cfg)
        cot = torch.ones((npix, 3), device=params.device)
        fwd_ms = device_ms(lambda: rk.launch(lib, params, v19, cfg, True))
        bwd_ms = device_ms(lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot))
    f, s = stats(frame_ms), stats(step_ms)
    return {
        f"render_{width}x{height}_Mrays_per_s": npix / f["median"] / 1e3,
        f"render_{width}x{height}_ms": f["median"],
        f"grad_{width}x{height}_Mrays_per_s": npix / s["median"] / 1e3,
        f"grad_{width}x{height}_ms": s["median"],
        "frame_ms": f, "grad_step_ms": s,
        "launch_ms_fwd": stats(fwd_ms), "launch_ms_bwd": stats(bwd_ms),
        "launches_per_frame": per_frame, "launches_per_step": per_step,
        "checks": {
            "4k: one image-forward launch per frame": per_frame == [1.0, 0.0],
            "4k: one forward and one backward launch per gradient step": per_step == [1.0, 1.0],
        },
    }


def bench_voxels(n: int = VOXEL_GRID) -> dict:
    """``voxelize`` of SphereRepeat over [-2, 2]^3 at n^3 with the grid
    materialised on the card (values and colours), on the host clock."""
    scene = scenes.sphere_repeat_scene()
    with torch.no_grad():
        ms = stats(host_ms(lambda: st.voxelize(scene, *BOUNDS, n, n, n)))
        v = st.voxelize(scene, *BOUNDS, n, n, n)
        ok = (v.values.shape == (n, n, n) and v.colors.shape == (n, n, n, 3)
              and bool(torch.isfinite(v.values).all() and torch.isfinite(v.colors).all()))
    return {
        "metric": f"voxel_samples_{n}^3",
        "value": n ** 3 / ms["median"] / 1e3,
        "unit": "Msamples/s",
        "seconds": ms["median"] / 1e3,
        "ms": ms,
        "fused_reduce_Msamples_per_s": None,
        "fused_reduce_note": "the port has no path that evaluates the cells without keeping "
                             "the grid",
        "checks": {f"voxels: the {n}^3 grid and its colours are finite": ok},
    }


def bench_mesh(n: int = 256, seq_reps: int = 2) -> dict:
    """``SdfExpr.to_mesh`` of SphereRepeat over [-2, 2]^3 at n^3 (voxelize on
    the card, then mesh), host clock, with the phase split
    (``marching_cubes.LAST_TIMINGS``, medians); beside it the sequential
    C++ baseline on the same grid fetched to the host, measured."""
    scene = scenes.sphere_repeat_scene()
    splits = []

    def mesh():
        m = scene.to_mesh(*BOUNDS, n, n, n)
        splits.append(dict(mc.LAST_TIMINGS))
        return m

    mesh()
    splits.clear()
    ms = stats(host_ms(mesh, warmup=0))
    m = mesh()
    vertices, triangles = len(m.vertices), len(m.triangles)
    del m
    with torch.no_grad():
        vox = st.voxelize(scene, *BOUNDS, n, n, n)
    values, colors = vox.values.cpu().numpy(), vox.colors.cpu().numpy()
    del vox
    seq = []
    for _ in range(seq_reps):
        t0 = time.perf_counter()
        seq_verts, seq_stream = native.mc_sequential_baseline(values, colors, 1, 0.0)
        seq.append((time.perf_counter() - t0) * 1e3)
    seq_ms = stats(seq)
    key = f"mesh_{n}^3"
    return {
        f"{key}_ms": ms["median"],
        f"{key}_ms_stats": ms,
        f"{key}_vertices": vertices,
        f"{key}_triangles": triangles // 3,
        f"{key}_phase_ms": {k: float(np.median([s[k] for s in splits])) for k in splits[0]},
        f"{key}_seq_baseline_ms": seq_ms["median"],
        f"{key}_seq_baseline_ms_stats": seq_ms,
        f"{key}_seq_baseline_Mcells_per_s": (n - 1) ** 3 / seq_ms["median"] / 1e3,
        f"{key}_vs_seq_baseline_x": seq_ms["median"] / ms["median"],
        "checks": {
            f"mesh: {n}^3 gives {MESH_VERTICES.get(n)} vertices": vertices == MESH_VERTICES.get(n),
            f"mesh: {n}^3 equals the sequential C++ baseline's counts":
                seq_verts == vertices and seq_stream == triangles,
        },
    }


def bench_mesh_512(mesh256: dict) -> dict:
    """``bench_mesh`` at 512^3, its sequential baseline measured (bench.py
    extrapolated it from 256^3) once; ``mesh256`` gives the extrapolation
    beside it."""
    out = bench_mesh(512, seq_reps=1)
    rate = mesh256.get("mesh_256^3_seq_baseline_Mcells_per_s")
    if rate:
        out["mesh_512^3_seq_baseline_extrapolated_ms"] = 511 ** 3 / rate / 1e3
    return out


def grads(scene, w: int, h: int, view, backend: str, target=None, iters: int = 40):
    """(flat leaf gradients, view gradient) of one scene: the mean squared
    error against ``target``, or the image sum without one."""
    zero_grads(scene)
    view = view.clone().requires_grad_()
    m = st.RayMarcher(w, h, scene, view=view, backend=backend, depth_iterations=iters)
    img = m.render()
    loss = img.sum() if target is None else torch.mean((img - target) ** 2)
    loss.backward()
    flat = torch.cat([(torch.zeros_like(q) if q.grad is None else q.grad).reshape(-1)
                      for q in st.leaves(scene)])
    return flat.detach().cpu().numpy(), view.grad.cpu().numpy()


def grads_close(got, ref, scale: float) -> tuple[bool, float]:
    """ROADMAP C.3's comparison of two float32 programs' gradients: leaves
    within rtol 2e-3 plus ``scale`` of the largest leaf entry, the view
    within rtol 5e-2 plus ``scale`` of its largest entry. Returns (ok, the
    largest error as a share of the largest entry, leaves or view)."""
    (leaf, vw), (rleaf, rvw) = got, ref
    scale_l, scale_v = float(np.abs(rleaf).max()), float(np.abs(rvw).max())
    err = max(float(np.abs(leaf - rleaf).max()) / max(scale_l, 1e-30),
              float(np.abs(vw - rvw).max()) / max(scale_v, 1e-30))
    ok = (bool(np.isfinite(leaf).all() and np.isfinite(vw).all())
          and np.allclose(leaf, rleaf, rtol=2e-3, atol=1e-5 + scale * scale_l)
          and np.allclose(vw, rvw, rtol=5e-2, atol=1e-3 + scale * scale_v))
    return ok, err


def _max_rel(got, ref) -> float:
    """bench.py's measure: the largest |difference| over every gradient entry
    over the largest reference entry."""
    return max(float(np.abs(g - r).max()) for g, r in zip(got, ref)) / max(
        max(float(np.abs(r).max()) for r in ref), 1e-6)


def bench_grad(width: int = WIDTH, height: int = HEIGHT) -> dict:
    """A gradient step (``RayMarcher.render().sum().backward()``) through the
    image forward and backward kernels against autograd of the plain path at
    the largest frame whose tape fits, in turns on the host clock; the
    backward launch alone (CUDA events). Parity: the kernels' gradient
    against the plain path's at 8 and 40 iterations on the fit's loss (the
    scene at radius 0.55, the target its frame at 0.5), the formulation
    ROADMAP C.3 bounds; the plain path against itself with the camera moved
    by 1e-6 beside it as the noise floor; the image sum's at 40 iterations
    as information."""
    scene, view = scenes.sphere_repeat_scene(), bench_view()
    marcher = st.RayMarcher(width, height, scene, view=view)
    step = Counted(lambda: gradient_step(marcher))
    plain_size = None
    for w, h in ((width, height), (width // 2, height // 2), (width // 4, height // 4)):
        plain = st.RayMarcher(w, h, scene, view=view, backend="torch")
        try:
            gradient_step(plain)
            plain_size = (w, h)
            break
        except torch.OutOfMemoryError:
            zero_grads(scene)
            torch.cuda.empty_cache()
    pw, ph = plain_size
    plain_ms, kernel_ms = in_turns(lambda: gradient_step(plain), step, host_ms)
    per_step = step.per_call()
    cfg, program = marcher.config, compile_scene(scene)
    with torch.no_grad():
        params = flat_params(scene).contiguous()
        v19 = rk.view19(view, cfg)
        bwd_lib = build.load_bwd(program)
        cot = torch.ones((width * height, 3), device=params.device)
        bwd_ms = device_ms(lambda: rk.launch_bwd(bwd_lib, params, v19, cfg, True, cot))
    zero_grads(scene)

    # Parity at the plain path's shape.
    start = scenes.sphere_repeat_scene()
    with torch.no_grad():
        target = st.RayMarcher(pw, ph, start, view=view).render().clone()
        st.leaves(start)[0].fill_(START_RADIUS)
    moved = st.look_at((EYE[0], EYE[1], EYE[2] + 1e-6), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    parity = {}
    for iters in (8, 40):
        ref = grads(start, pw, ph, view, "torch", target, iters)
        got = grads(start, pw, ph, view, "kernel", target, iters)
        ok, err = grads_close(got, ref, GRAD_PARITY_BOUND)
        _, floor = grads_close(grads(start, pw, ph, moved, "torch", target, iters), ref,
                               GRAD_PARITY_BOUND)
        parity[iters] = (ok, err, floor)
    sum_err = _max_rel(grads(scene, pw, ph, view, "kernel"), grads(scene, pw, ph, view, "torch"))
    zero_grads(scene)
    k, p = stats(kernel_ms), stats(plain_ms)
    return {
        "grad_Mrays_per_s": width * height / k["median"] / 1e3,
        "grad_ms": k["median"],
        "grad_backend": marcher.backend,
        "grad_ms_kernel": k,
        "grad_ms_plain": p,
        "grad_plain_shape": [pw, ph],
        "grad_plain_Mrays_per_s": pw * ph / p["median"] / 1e3,
        "bwd_launch_ms": stats(bwd_ms),
        "launches_per_timed_step": per_step,
        "grad_parity_ok": parity[40][0],
        "grad_parity_max_rel_err_8iter": parity[8][1],
        "grad_parity_noise_floor_8iter": parity[8][2],
        "grad_parity_max_rel_err_40iter": parity[40][1],
        "grad_parity_noise_floor_40iter": parity[40][2],
        "grad_parity_40iter_ok": parity[40][0],
        "grad_parity_image_sum_max_rel_err_40iter": sum_err,
        "grad_parity_shape": [pw, ph],
        "grad_parity_bound": GRAD_PARITY_BOUND,
        "checks": {
            "grad: one forward and one backward launch per timed step": per_step == [1.0, 1.0],
            f"grad: the kernels' gradient at {pw}x{ph}x40 within ROADMAP C.3's bound of the "
            f"plain path's": parity[40][0],
        },
    }


def icp_cloud(n: int):
    """bench.py's cloud: seed 7, uniform in [-1, 1]^3, rotated 0.02 rad about
    z and moved by (0.03, -0.02, 0.01)."""
    rng = np.random.default_rng(7)
    static = rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    ang = 0.02
    rot = np.array([[np.cos(ang), np.sin(ang), 0], [-np.sin(ang), np.cos(ang), 0], [0, 0, 1]],
                   np.float32)
    return static, static @ rot + np.float32([0.03, -0.02, 0.01])


def icp_iterations(reg, moved) -> tuple[int, str]:
    """(the iterations of one registration, its search): one search an
    iteration, counted."""
    searches = []
    grid = reg._nn.grid()
    if grid is not None and grid.ok:
        query = grid.query
        grid.query = lambda q: searches.append(1) or query(q)
        try:
            reg.register_points(moved)
        finally:
            del grid.query
        return len(searches), "grid"
    brute = icp.nearest_neighbors
    icp.nearest_neighbors = lambda *a, **k: searches.append(1) or brute(*a, **k)
    try:
        reg.register_points(moved)
    finally:
        icp.nearest_neighbors = brute
    return len(searches), "brute"


def bench_icp(sizes=ICP_POINTS) -> dict:
    """``IterativeClosestPoint.register_points`` (the device loop) on
    bench.py's cloud at each size, host clock, with its iterations and the
    alignment against the static cloud."""
    out, checks = {}, {}
    for n in sizes:
        static, moved = icp_cloud(n)
        reg = st.IterativeClosestPoint(static)
        ms = stats(host_ms(lambda: reg.register_points(moved), warmup=1))
        aligned, _ = reg.register_points(moved)
        err = float(np.abs(aligned - static).max())
        out[f"icp_{n}_ms"] = ms["median"]
        out[f"icp_{n}_ms_stats"] = ms
        out[f"icp_{n}_max_err"] = err
        out[f"icp_{n}_iterations"], out[f"icp_{n}_nn"] = icp_iterations(reg, moved)
        checks[f"icp: {n} points aligned within {ICP_TOL:g}"] = err <= ICP_TOL
    out["checks"] = checks
    return out


def scaling_audit(process_group: str, devices, width: int, height: int, iters: int) -> dict:
    """The JSON of ``tools/torch_scaling.py`` over ``devices`` ranks of one
    ``process_group`` group (``gloo``: every rank on this card; ``nccl``: a
    card each), read from its standard output; raises when it fails."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_scaling.py"), "--process-group",
         process_group, "--devices", *(str(n) for n in devices), "--width", str(width),
         "--height", str(height), "--iters", str(iters), "--timeout", str(AUDIT_TIMEOUT)],
        capture_output=True, text=True, timeout=AUDIT_TIMEOUT + 60, cwd=ROOT)
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f"tools/torch_scaling.py --process-group {process_group} exited "
                           f"{proc.returncode}:\n{proc.stderr[-4000:]}")
    return json.loads(lines[-1])


def audit_points(audit: dict, fixed_operations: float, what: str) -> tuple[dict, dict]:
    """(the audit's points as the bench reports them, its checks): frames
    equal to one rank's, one launch per rank and frame, no nvcc on a rank,
    the work at one rank the frame's fixed work, split evenly."""
    points = audit["points"]
    summary = {
        "process_group": audit["process_group"], "nvcc_builds": audit["nvcc_builds"],
        "rank_devices": audit["rank_devices"],
        "points": [{k: p[k] for k in ("devices", "ms", "mrays_per_s", "walltime_efficiency_pct",
                                      "band_ms", "band_efficiency_pct", "shared_device",
                                      "work_partition_efficiency_pct", "launches_per_frame")}
                   for p in points]}
    checks = {
        f"scaling: the {what}'s frames equal one rank's": all(p["frame_equal_to_one_rank"]
                                                            for p in points),
        f"scaling: the {what} launched once per rank and frame and built nothing":
            all(p["launches_per_frame"] == [1.0] * p["devices"] for p in points)
            and audit["nvcc_builds"] == [0] * audit["num_processes"],
        f"scaling: the {what}'s work at one rank is the frame's fixed work, split evenly":
            points[0]["per_device_operations"] == fixed_operations
            and all(p["work_partition_efficiency_pct"] == 100.0 for p in points),
    }
    return summary, checks


def bench_scaling(width: int = WIDTH_4K, height: int = HEIGHT_4K, audit=scaling_audit) -> dict:
    """4K row bands of ``ceil(H / n)`` rows through ``render_rows_kernel``
    (the program ``build_sharded_render`` puts on each rank), each alone on
    the card (CUDA events): efficiency(n) = T(full) / (n T(band)), capped at
    100 as in bench.py (the raw ratio beside it); then the audit,
    ``tools/torch_scaling.py`` over 1, 2 and 4 ``gloo`` ranks on this card,
    and where the machine has more cards, over 1, 2 and 4 of them under
    NCCL, a rank on each (``torch_scaling_cards``): frames that run at the
    same time, whose walltime efficiency is ms(1) / (n ms(n))."""
    scene, view = scenes.sphere_repeat_scene(), bench_view()
    cfg = st.RenderConfig(width, height)
    ivp, cam = inv_view_proj(view, width, height, cfg.vfov_degrees, cfg.near, cfg.far)
    points = []
    with torch.no_grad():
        for n in SCALING_COUNTS:
            rows = -(-height // n)
            band = Counted(lambda rows=rows: rk.render_rows_kernel(scene, ivp, cam, 0, cfg, rows))
            ms = stats(device_ms(band))
            points.append({"devices": n, "rows_per_chip": rows, "shard_ms": ms["median"],
                           "shard_ms_stats": ms, "launches_per_band": band.per_call()[0]})
    full = points[0]["shard_ms"]
    for p in points:
        raw = 100.0 * full / (p["devices"] * p["shard_ms"])
        p["aggregate_mrays_per_s"] = width * height / p["shard_ms"] / 1e3
        p["efficiency_raw_pct"] = raw
        p["efficiency_pct"] = min(100.0, raw)
    out = {"real_chip_shard_scaling": points}
    out.update({f"scaling_efficiency_n{p['devices']}_pct": p["efficiency_pct"]
                for p in points if p["devices"] > 1})
    checks = {"scaling: one image-forward launch per band":
              all(p["launches_per_band"] == 1.0 for p in points)}

    fixed = work.frame_work(compile_scene(scene), cfg.depth_iterations, width * height, 0,
                            0)["fwd_fixed"].operations
    cards = torch.cuda.device_count()
    audits = [("torch_scaling_audit", "gloo", AUDIT_RANKS, "audit")]
    if cards > 1:
        audits.append(("torch_scaling_cards", "nccl", tuple(n for n in AUDIT_RANKS if n <= cards),
                       "cards audit"))
    for key, group, ranks, what in audits:
        try:
            found = audit(group, ranks, width, height, cfg.depth_iterations)
        except RuntimeError as e:
            print(str(e), file=sys.stderr)
            checks[f"scaling: the {what} ran its ranks"] = False
            continue
        out[key], audit_checks = audit_points(found, fixed, what)
        checks.update(audit_checks)
        if group == "nccl":
            checks["scaling: the cards audit put each rank on a card of its own"] = (
                len(set(found["rank_devices"])) == found["num_processes"]
                and not any(p["shared_device"] for p in found["points"]))
            out.update({f"cards_walltime_efficiency_n{p['devices']}_pct":
                        p["walltime_efficiency_pct"] for p in found["points"] if p["devices"] > 1})
    apoints = out.get("torch_scaling_audit", {}).get("points")
    if apoints:
        out[f"spmd_work_partition_n{apoints[-1]['devices']}_pct"] = \
            apoints[-1]["work_partition_efficiency_pct"]
    out["checks"] = checks
    return out


# -- the run -------------------------------------------------------------------------

def _smi(query: str, units: bool = True) -> str | None:
    """One value of ``nvidia-smi --query-gpu`` for card 0, or None."""
    fmt = "csv,noheader" if units else "csv,noheader,nounits"
    try:
        proc = subprocess.run(["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
                              capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = proc.stdout.strip().splitlines()
    return lines[0].strip() if proc.returncode == 0 and lines else None


def power_limit_w() -> float | None:
    value = _smi("power.limit", units=False)
    try:
        return float(value)
    except (TypeError, ValueError):
        return None


HEADLINE_KEYS = (
    "render_ms", "backend", "render_ms_plain", "launch_ms", "build_s", "lightspeed_ms",
    "lightspeed_ms_fixed", "bwd_lightspeed_ms", "kernel_device_ms_fwd", "kernel_device_ms_bwd",
    "issue_share_fwd", "issue_share_bwd", "render_3840x2160_ms", "grad_3840x2160_ms",
    "voxel_Msamples_per_s", "voxel_fused_reduce_Msamples_per_s", "mesh_256^3_ms",
    "mesh_256^3_vertices", "mesh_256^3_seq_baseline_ms", "mesh_256^3_vs_seq_baseline_x",
    "mesh_512^3_ms", "mesh_512^3_vertices", "mesh_512^3_seq_baseline_ms",
    "mesh_512^3_vs_seq_baseline_x", "grad_ms", "grad_ms_plain", "grad_plain_shape",
    "grad_parity_ok", "grad_parity_max_rel_err_40iter", "icp_10000_ms", "icp_10000_max_err",
    "icp_10000_iterations", "icp_100000_ms", "icp_100000_max_err", "icp_100000_iterations",
    "scaling_efficiency_n2_pct", "scaling_efficiency_n4_pct", "scaling_efficiency_n8_pct",
    "spmd_work_partition_n4_pct", "cards_walltime_efficiency_n2_pct",
    "cards_walltime_efficiency_n4_pct", "fused_drift_1920x1080_px_gt_1e-2",
    "fused_drift_1920x1080_px_gt_5e-2",
)


def _short(v):
    """A headline value: medians for timings, 6 significant digits for floats."""
    if isinstance(v, dict) and "median" in v:
        v = v["median"]
    if isinstance(v, dict):
        return {k: _short(x) for k, x in v.items()}
    return float(f"{v:.6g}") if isinstance(v, float) else v


def headline(render: dict, found: dict, correct: bool, tag: dict) -> dict:
    """bench.py's last line: the render's metric and the other sections'
    key figures under ``extra``."""
    extra = {k: _short(found[k]) for k in HEADLINE_KEYS if k in found}
    extra.update(correct=correct, **tag)
    return {"metric": render.get("metric", f"sphere_repeat_render_{WIDTH}x{HEIGHT}"),
            "value": _short(render.get("value")), "unit": "Mrays/s",
            "vs_baseline": _short(render.get("vs_baseline")), "extra": extra}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the whole run to "
                         "DIR/trace.json.gz")
    opts = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is false; this benchmark measures the port "
              "on a CUDA card and does not run on the CPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = {"device": torch.cuda.get_device_name(0), "power_limit_w": power_limit_w()}
    checks: dict = {}
    found: dict = {}
    results: dict = {}

    def run(name, fn, *args):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            out = fn(*args)
        except Exception as e:  # the run goes on; the section fails and the exit code says so
            traceback.print_exc()
            out = {"error": repr(e), "checks": {f"{name}: ran": False}}
        sync()
        line = {"section": name, **out, "seconds": time.perf_counter() - t0,
                "peak_device_bytes": torch.cuda.max_memory_allocated(), **tag}
        print(json.dumps(line), flush=True)
        checks.update(out.pop("checks", {}))
        found.update(out.get("extra", {}))
        found.update(out)
        for key, drift in out.get("fused_drift", {}).items():
            for k in ("px_gt_1e-2", "px_gt_5e-2"):
                found[f"{key}_{k}"] = drift[k]
        results[name] = out
        return out

    profiler = contextlib.nullcontext()
    if opts.profile:
        from torch.profiler import ProfilerActivity, profile

        profiler = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with profiler as prof:
        render = run("render", bench_render)
        roofline = run("roofline", bench_roofline, render)
        if opts.profile:
            print(json.dumps({"section": "occupancy", "skipped": "under --profile: profiler "
                              "sessions cannot nest", **tag}), flush=True)
        else:
            run("occupancy", bench_occupancy, roofline)
        run("fused_drift", bench_fused_drift)
        run("4k", bench_4k)
        voxels = run("voxels", bench_voxels)
        mesh = run("mesh", bench_mesh)
        run("mesh_512", bench_mesh_512, mesh)
        run("grad", bench_grad)
        run("icp", bench_icp)
        run("scaling", bench_scaling)
    found["voxel_Msamples_per_s"] = voxels.get("value")
    found["voxel_fused_reduce_Msamples_per_s"] = voxels.get("fused_reduce_Msamples_per_s")
    if opts.profile:
        os.makedirs(opts.profile, exist_ok=True)
        prof.export_chrome_trace(os.path.join(opts.profile, "trace.json.gz"))
        found["profile_dir"] = opts.profile
    failed = [k for k, ok in checks.items() if not ok]
    for k in failed:
        print(f"bench_torch: FAIL {k}", file=sys.stderr)
    line = headline(render, found, not failed and bool(checks), tag)
    if opts.profile:
        line["extra"]["profile_dir"] = opts.profile
    print(json.dumps(line), flush=True)
    return 1 if failed or not checks else 0


if __name__ == "__main__":
    sys.exit(main())
