"""The ``frames`` loop: a viewer's closed loop with one client. Each frame
is ``RayMarcher.render(camera=view_k)`` and a synchronise, the view moving
along the configuration's orbit from a frame the seed picks. It reports
``frame_ms`` (the window over its frames), ``setup_s`` and, untraced on a
card, where the cell names it, ``frame_device_ms``: the device's busy time
over the window's frames, from a trace of the device's activity alone.
``setup_s`` ends where the tracer starts: its start (``tracer_s`` in the
line's ``setup``) is the benchmark's, not the program's."""

from __future__ import annotations

import time

import torch

import sdfkit_tpu_torch as st
from sdfkit_tpu_torch.render.cuda import build
from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk

from benchmark.harness import check, faults, generate, spec
from benchmark.harness import window as w
from benchmark.reference import render as ref

WARM_FRAMES = 3


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device,
        t0: float) -> w.Outcome:
    config = cell.config
    cfg = generate.render_config(config)
    ref_mod, port_mod = spec.scene_modules(config["scene"]["kind"])
    table = ref_mod.table(config["scene"], device)
    views = generate.views(config["view"], device)
    period, k0 = views.shape[0], generate.first_frame(config["view"], seed)
    kept = w.Reservoir(int(config["check"]["frames"]), generate.host_rng(seed, "frames checked"))
    w.sync(device)

    t_build = time.perf_counter()
    setup = {"inputs": t_build - t0}
    expr = port_mod.build(table, device)
    marcher = st.RayMarcher(cfg["width"], cfg["height"], expr, view=views[k0],
                            **generate.march_kwargs(cfg))
    with torch.no_grad():
        marcher.render(camera=views[k0])
        w.sync(device)
        first_frame_s = time.perf_counter() - t_build
        setup["first_frame"] = time.perf_counter() - t0
        for j in range(1, WARM_FRAMES):
            marcher.render(camera=views[(k0 + j) % period])
        w.sync(device)
    builds = build.BUILDS

    limit = w.window_seconds(seconds, traced)
    wanted = {m["name"].split(".")[0] for m in cell.end_to_end}
    clocked = not traced and w.on_card(device) and "frame_device_ms" in wanted
    t_ready = time.perf_counter()  # the tracer's start, below, is not the program's set-up
    with torch.no_grad(), w.Profiled(traced, device,
                                     lambda: marcher.render(camera=views[k0])) as prof, \
            w.DeviceClock(clocked) as clock:
        launches0, n, host_s = rk.LAUNCHES, 0, 0.0
        t_start = time.perf_counter()
        while True:
            k = (k0 + n) % period
            t_a = time.perf_counter()
            out = marcher.render(camera=views[k])
            t_b = time.perf_counter()
            w.sync(device)
            t_c = time.perf_counter()
            host_s += t_b - t_a
            n += 1
            kept.offer((k, out))
            if t_c - t_start >= limit:
                break
    window_s = t_c - t_start
    launches = rk.LAUNCHES - launches0
    peak = w.peak(device)
    summary = prof.reduce()
    setup["tracer_s"] = t_start - t_ready
    end_to_end = {"frame_ms": window_s / n * 1e3, "setup_s": t_ready - t0}
    busy_s = clock.busy_s()
    if busy_s is not None:
        end_to_end["frame_device_ms"] = busy_s / n * 1e3
    del marcher, expr, out
    w.free(device)

    readings = [check.frame_numbers(frame, ref.render(ref_mod, table, views[k], cfg))
                for k, frame in kept.items]
    numbers = check.worst(readings)
    numbers["launch_gap"] = abs(launches - (n if w.on_card(device) else 0))
    failed = sum(not all(c.ok for c in check.judge(r, cell.limits)) for r in readings)
    ctx = {"loop": "frames", "config": config, "count": n, "window_s": window_s,
           "host_render_s": host_s, "first_frame_s": first_frame_s, "summary": summary}
    if traced:
        sample = int(config["check"]["roofline_views"])
        picked = sorted({(k0 + j * n // sample) % period for j in range(sample)})
        ctx["needs"] = w.mean_needs([ref.march_needs(ref_mod, table, views[k], cfg)
                                     for k in picked])
    return w.Outcome(attempted=n, failed=failed, end_to_end=end_to_end,
                     ctx=ctx, checks=check.judge(numbers, cell.limits), setup=setup,
                     memory_peak_bytes=peak, builds=builds)


def control_readings(cell: spec.Cell, seed: int, device) -> dict:
    """{kind: numbers} over as many frames as a run checks, at views the
    seed picks along the orbit: the control, and the look at the first
    view's frame with the camera nudged."""
    config = cell.config
    cfg = generate.render_config(config)
    ref_mod, _ = spec.scene_modules(config["scene"]["kind"])
    table = ref_mod.table(config["scene"], device)
    views = generate.views(config["view"], device)
    rng = generate.host_rng(seed, "control")
    picked = [rng.randrange(views.shape[0]) for _ in range(int(config["check"]["frames"]))]
    want = [ref.render(ref_mod, table, views[k], cfg) for k in picked]
    control = [check.frame_numbers(ref.render(ref_mod, table, views[k], cfg, dtype=faults.LOW),
                                   v) for k, v in zip(picked, want)]
    nudged = ref.render(ref_mod, table, faults.nudged(config["view"], device), cfg)
    return {"control": check.worst(control),
            "nudged": check.frame_numbers(nudged, ref.render(
                ref_mod, table, generate.fixed_view(config["view"], device), cfg))}
