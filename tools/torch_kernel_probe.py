#!/usr/bin/env python3
"""Probe the sphere-trace CUDA kernels of sdfkit_tpu_torch on one GPU.

    python3 tools/torch_kernel_probe.py [--against DIR ...] [--tag NAME] [--scenes NAME ...]
    python3 tools/torch_kernel_probe.py --tiers N ... | --budgets K ... | [--rows] [--taps N ...]
    python3 tools/torch_kernel_probe.py --loops N ... [--against DIR ...]

Builds the six kernel libraries for SphereRepeat (the image forward and
backward, their depth-history builds, the ray-batch pair) and for one sphere,
or for the scenes ``--scenes`` names (``union_grid`` is the 200-sphere union
of ``scenes.union_grid_scene``, 1,400 parameter slots, built in a package
that predates it from this checkout's table with that package's DSL), and
prints, one JSON object per line with ``"probe"`` naming it:

* ``program``: per scene its parameter slots and operation counts;
* ``build``: per library (of every scene but one sphere) the nvcc seconds,
  the registers, stack and spills ``ptxas -v`` reported, the resident blocks per SM the occupancy calculator gives, and
  from ``cuobjdump -sass`` the instructions of each kernel and of each of its
  loops with their square roots, reciprocals and division range checks;
* ``listing``: the SASS of the store-fed backward's sweep loop, per package;
* ``frame``: per scene the hit pixels, a hash of the frame and the image
  backward's gradient of a seeded cotangent, so that runs can be held
  against each other;
* ``same``: the store-fed backward of every package against this
  checkout's, fed the same depth history and cotangent (bit for bit), and
  the image and ray-batch backwards likewise (the largest difference over the
  largest entry);
* ``forward``: per scene and per package (this checkout's and every
  ``--against`` package's) whether its forwards' outputs are bit for bit the
  first ``--against`` package's (this checkout's without one): RGB and depth of the image forward, RGB and depth history of the
  forward with store, RGB, hit flags and depth of the ray-batch forward, the
  frame's rays in a seeded shuffled order against the same rays in order,
  two bands of an odd pixel count (store rows against the frame's columns),
  and all of it again at 80 and 130 iterations on SphereRepeat;
* ``settle``: per scene, from the depth history, the step at which each
  ray's march reaches its bitwise fixed point, and the share of a warp's
  march steps that leaving at it saves when the test comes every 1, 2, 4 or
  8 steps, for the frame's order and the shuffled one;
* ``time``: CUDA-event times of the launches alone, queued behind a sleep on
  the stream so that the card's time is read and not the host's (a launch
  on the mostly-sky frame is shorter than the host's work to make it), at
  1920x1080x40 on SphereRepeat (nearly every pixel hits) and on one sphere
  of radius 0.5 under the same camera (mostly sky), in turns, there and back, twice: the
  image backward, the store-fed backward and the ray-batch backward on the
  frame's camera rays (with the forward's hit flags where the package has
  them, and without), and the forwards (image, with store, ray-batch with
  and without hit flags, ray-batch on the shuffled rays) of every package.

``--tiers N ...`` does only this: for the union of N spheres
(``scenes.union_grid_scene(N)``, 7 N slots) at each N, the image backward
built in both tiers of the scene compiler (``LARGE_SCENE_SLOTS`` set above
and below the scene's slots) and timed at 1920x1080x40 from the default
camera, in turns, one ``tier`` line per scene and tier: the measurement the
tier threshold is chosen from.

``--budgets K ...`` does only this: the image backward and the store-fed
backward of the 200-sphere union built with the large tier's register budget
set for K resident blocks an SM in both builds (``kBwdLargeMinBlocks`` in
``csrc/raymarch_reduce.cuh``, edited in a copy of ``csrc/`` for each K), and
timed at 1920x1080x40 in turns, one ``budget`` line per K: the measurement
the constant is chosen from.

``--rows`` and ``--taps N ...`` (together or apart) do only this, each
library built from a copy of ``csrc/`` with the variant's text in place:
``--rows`` times the 200-sphere union's image backward at 1920x1080x40 with
its sums in each of ``ROW_PLACES`` (the kernels' rows a warp in device
memory, a block's row in shared memory, a row a warp in shared memory), one
``rows`` line each with its difference from the kernels' gradient and
whether two launches agree bit for bit; ``--taps`` times the RGB forward of
SphereRepeat and of ``union_grid_scene(N)`` at each N with the six normal
taps straight-line and a loop over the axes, one ``taps`` line per scene
and form with whether the two frames agree bit for bit: the measurements
the large tier's sums and the forward's taps are chosen from.

``--loops N ...`` does only this: the RGB image forward of
``union_grid_scene(N)`` at each N, of this checkout and of every
``--against`` package, timed in turns at 1920x1080x40 from the default
camera, one ``loops`` line per package, N and kernel family with the time
per sphere, a forward's SASS size and loops, and whether its output is bit
for bit the first ``--against`` package's; at the largest N every family
(the image forward and backward, their depth-history builds, the ray-batch
pair on the frame's rays, the backward with the forward's hit flags), and
this checkout's forward and image backward built with the loops of the
unions of like children unrolled by 2 (``unroll2``; ``unroll1`` where
``LOOP_UNROLL`` is 2) and its forward reading the parameters from the
constant bank instead of shared memory (``constant``), one
``loops_variant`` line each. At every N below the largest, this
checkout's image backward, whose adjoints pull the union back as a loop,
and the same built with the straight-line adjoints (``straight_adjoint``,
the program's loops dropped from its adjoints alone): where the loop form
overtakes. At the largest N the image backward once more, built with
counters in its adjoints (``counted``, the adjoint source edited in a copy:
the program's own build counts nothing), on the fit's frame: per adjoint
(``sdf_dist_vjp``, ``sdf_dist_vjp_pair``, ``sdf_eval_vjp``) the warp-calls
that reach the union's pullback with some lane's cotangent, the share of
them that take the tree's rule at a tie, and the passes of a child's
adjoint per warp-call, one ``loops_counted`` line. This checkout's program
takes the loop form at every N here, whatever ``LOOP_MIN_CHILDREN`` says:
the measurements the loop form's threshold, unroll and table's home are
chosen from.

``--against DIR`` (repeatable) names a directory that holds another
``sdfkit_tpu_torch`` (an earlier commit unpacked beside this one, e.g.
``git archive <commit> sdfkit_tpu_torch | tar -x -C DIR``); each is imported
in this same process under its own module objects, builds into its own
``_build/`` and is timed in the same turns. Every line carries ``--tag`` and
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib
import inspect
import json
import pathlib
import subprocess
import sys
import time
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = "sdfkit_tpu_torch"
WIDTH, HEIGHT = 1920, 1080
WARMUP, TIMED = 3, 10
# A sleep on the stream ahead of the timed calls: about 20 ms at 1980 MHz.
SLEEP_CYCLES = 40_000_000
FWD_FAMILIES = ("fwd", "fwd_store", "rays_fwd")
ODD = 1_000_001  # the first band's pixels: no row of its store starts 16-byte aligned


def load_package(root: pathlib.Path) -> types.SimpleNamespace:
    """The modules of the ``sdfkit_tpu_torch`` under ``root``, imported under
    their own names and then taken out of ``sys.modules`` again, so that
    packages of several commits live in one process side by side."""
    def ours():
        return [k for k in sys.modules if k == PKG or k.startswith(PKG + ".")]

    saved = {k: sys.modules.pop(k) for k in ours()}
    sys.path.insert(0, str(root))
    try:
        pkg = types.SimpleNamespace(
            st=importlib.import_module(PKG),
            scenes=importlib.import_module(PKG + ".scenes"),
            build=importlib.import_module(PKG + ".render.cuda.build"),
            rk=importlib.import_module(PKG + ".render.cuda.raymarch_kernel"),
            compile=importlib.import_module(PKG + ".sdf.compile"),
            camera=importlib.import_module(PKG + ".utils.camera"),
            sass=importlib.import_module(PKG + ".render.cuda.sass"),
            raymarch=importlib.import_module(PKG + ".render.raymarch"),
        )
    finally:
        sys.path.remove(str(root))
        for k in ours():
            del sys.modules[k]
        sys.modules.update(saved)
    if pkg.build.PACKAGE_DIR.resolve() != (root / PKG).resolve():
        raise RuntimeError(f"{root}: imported {pkg.build.PACKAGE_DIR} instead")
    return pkg


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", action="append", default=[],
                    help="another package root to probe beside this checkout")
    ap.add_argument("--tag", default="")
    ap.add_argument("--scenes", nargs="+", default=["sphere_repeat", "one_sphere"],
                    choices=["sphere_repeat", "one_sphere", "union_grid"])
    ap.add_argument("--tiers", nargs="+", type=int, default=[],
                    help="sphere counts of union_grid_scene to time in both backward tiers")
    ap.add_argument("--budgets", nargs="+", type=int, default=[],
                    help="resident blocks an SM to build the large tier's backwards for")
    ap.add_argument("--rows", action="store_true",
                    help="time the large tier's image backward with its sums in each of "
                         "ROW_PLACES")
    ap.add_argument("--taps", nargs="+", type=int, default=[],
                    help="sphere counts of union_grid_scene whose forward (and SphereRepeat's) "
                         "to time with the taps straight-line and a loop over the axes")
    ap.add_argument("--loops", nargs="+", type=int, default=[],
                    help="sphere counts of union_grid_scene whose forward to time in every "
                         "package, with the loop form's variants at the largest")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    packages = {"this": load_package(ROOT)}
    for root in args.against:
        packages[pathlib.Path(root).name] = load_package(pathlib.Path(root).resolve())
    this = packages["this"]
    sass = this.sass  # this checkout's reader, whatever package built the library

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def say(probe, **fields):
        print(json.dumps({"probe": probe, "tag": args.tag, "gpu": smi, **fields}), flush=True)

    def events(fn) -> float:
        """Device ms per call of ``fn``. The timed calls queue up behind a
        sleep on the stream, so that a launch shorter than the host's time to
        make the call (a frame that is mostly sky) is timed on the card, not
        at the rate the host enqueues; a round whose calls took the host
        longer than the sleep is refused."""
        for _ in range(WARMUP):
            fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        t0 = time.perf_counter()
        for _ in range(TIMED):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        torch.cuda.synchronize()
        if host_ms >= sleep_ms:
            raise RuntimeError(f"the host took {host_ms:.3f} ms to queue {TIMED} calls, longer "
                               f"than the {sleep_ms:.3f} ms sleep ahead of them")
        return start.elapsed_time(stop) / TIMED

    def time_sleep() -> float:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        torch.cuda._sleep(SLEEP_CYCLES)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    time_sleep()
    sleep_ms = time_sleep()

    if args.tiers:
        return tier_sweep(this, args.tiers, say, events)
    if args.loops:
        return loops_sweep(packages, args.loops, say, events)
    if args.budgets:
        return budget_sweep(this, args.budgets, say, events)
    if args.rows or args.taps:
        import shutil
        import tempfile

        work = pathlib.Path(tempfile.mkdtemp(prefix="variants"))
        jobs = {**(rows_jobs(this, work) if args.rows else {}),
                **(taps_jobs(this, work, args.taps) if args.taps else {})}
        libs = build_variants(this, work, jobs)
        if args.rows:
            rows_sweep(this, libs, say, events)
        if args.taps:
            taps_sweep(this, libs, args.taps, say, events)
        shutil.rmtree(work, ignore_errors=True)
        return 0

    # SphereRepeat and the sphere from bench.py's camera; the union grid from
    # the default camera, whose frame it fills.
    views = {"sphere_repeat": this.st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)),
             "union_grid": this.st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))}
    cfg = this.st.RenderConfig(WIDTH, HEIGHT)
    def union_grid(p):
        """The 200-sphere union in package ``p``, from this checkout's table."""
        if hasattr(p.scenes, "union_grid_scene"):
            return p.scenes.union_grid_scene()
        t = this.scenes.union_grid_table()
        return this.scenes.balanced_union([
            p.st.sphere(float(r), color=tuple(map(float, c))).translate(*map(float, o))
            for r, c, o in zip(t["radius"], t["color"], t["offset"])])

    makers = {"sphere_repeat": lambda p: p.scenes.sphere_repeat_scene(),
              "one_sphere": lambda p: p.st.sphere(0.5), "union_grid": union_grid}
    scenes = {label: {name: makers[name](p) for name in args.scenes}
              for label, p in packages.items()}
    programs = {label: {name: p.compile.compile_scene(expr) for name, expr in scenes[label].items()}
                for label, p in packages.items()}

    # Every library this run needs, built in parallel (one nvcc each).
    jobs = [(label, family, name) for label, p in packages.items()
            for family in p.build.FAMILIES for name in programs[label]]

    def load(job):
        label, family, name = job
        return packages[label].build.load_family(programs[label][name], family)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip(jobs, pool.map(load, jobs)))
    for name, prog in programs["this"].items():
        say("program", scene=name, parameter_slots=prog.n_params,
            operations=this.compile.operation_counts(prog),
            square_roots_per_distance=sum(prog.nodes[i][0] == "sqrt" for i in prog.dist_live))
    for (label, family, name), lib in libs.items():
        if name == "one_sphere":
            continue
        say("build", package=label, scene=name, family=family, nvcc_seconds=lib.build_seconds,
            registers=lib.registers, local_memory=lib.local_memory,
            resident_blocks_per_sm={"rgb": lib.resident(1), "depth": lib.resident(0)},
            sass=sass.library_sass(lib.path))

    def sweep_listing(lib):
        """The SASS of the last loop of the RGB kernel that evaluates the
        scene (a backward's sweep), instruction by instruction."""
        tool = sass.cuobjdump_path()
        parsed = sass.library_sass(lib.path)
        if tool is None or parsed is None:
            return None
        loops = [lp for lp in parsed["rgb"]["loops"]
                 if lp["rsq"] > 0 and lp["own"] == lp["instructions"]]
        text = subprocess.run([tool, "-sass", str(lib.path)], capture_output=True, text=True).stdout
        out, current = [], None
        for line in text.splitlines():
            m = sass._FUNCTION.match(line)
            if m:
                current = sass.kernel_key(m.group(1))
                continue
            m = sass._INSTRUCTION.match(line)
            at = int(m.group(1), 16) if m else -1
            if current == "rgb" and loops[-1]["start"] <= at <= loops[-1]["end"]:
                out.append(line.split(";")[0].strip() + " ;")
        return out

    for (label, family, name), lib in libs.items():
        if name == "sphere_repeat" and family == "bwd_store":
            say("listing", package=label, scene=name, family=family, sweep=sweep_listing(lib))

    def lib_of(label, family, name):
        return libs[(label, family, name)]

    def rays_bwd(label, lib, params, rays, cot, hit):
        """A package's ray pullback; with ``hit`` where its wrapper takes it."""
        fn = packages[label].rk.launch_rays_bwd
        if hit is not None and "hit" in inspect.signature(fn).parameters:
            return lambda: fn(lib, params, rays, cfg, True, cot, hit=hit)
        return lambda: fn(lib, params, rays, cfg, True, cot)

    ref_label = next((label for label in packages if label != "this"), "this")

    def bits(t):
        return t.contiguous().view(torch.int32)

    def same_bits(a, b) -> bool:
        if a.dtype != torch.float32:  # the hit flags
            return a.shape == b.shape and bool(torch.equal(a, b))
        return a.shape == b.shape and bool(torch.equal(bits(a), bits(b)))

    def forward_outputs(label, name, params, v19, c, rays, order):
        """Every forward output of package ``label`` on scene ``name`` at ``c``:
        image RGB and depth, RGB and history with store, ray RGB, hit flags
        and depth, and the RGB of the rays in ``order`` (None: not asked)."""
        rk = packages[label].rk
        fwd, store_lib, rays_lib = (lib_of(label, f, name) for f in FWD_FAMILIES)
        out = {"rgb": rk.launch(fwd, params, v19, c, True),
               "depth": rk.launch(fwd, params, v19, c, False)}
        out["store_rgb"], out["store"] = rk.launch(store_lib, params, v19, c, True,
                                                   want_store=True)
        out["ray_rgb"], out["hit"] = rk.launch_rays(rays_lib, params, rays, c, True,
                                                    want_hit=True)
        out["ray_depth"] = rk.launch_rays(rays_lib, params, rays, c, False)
        if order is not None:
            out["shuffled_rgb"], out["shuffled_hit"] = rk.launch_rays(
                rays_lib, params, [r[order] for r in rays], c, True, want_hit=True)
        return out

    def band_outputs(label, name, params, v19, c):
        """The forward with store over two bands of an odd pixel count."""
        rk = packages[label].rk
        store_lib = lib_of(label, "fwd_store", name)
        return [rk.launch(store_lib, params, v19, c, True, b0, bn, want_store=True)
                for b0, bn in ((0, ODD), (ODD, WIDTH * HEIGHT - ODD))]

    def compare(got, ref, order) -> dict:
        """Which outputs are bit for bit the reference's."""
        verdict = {k: same_bits(got[k], ref[k]) for k in ref if not k.startswith("shuffled")}
        if order is not None:
            verdict["shuffled_rgb"] = same_bits(got["shuffled_rgb"], ref["ray_rgb"][order])
            verdict["shuffled_hit"] = same_bits(got["shuffled_hit"], ref["hit"][order])
        return verdict

    def settle_report(store, order):
        """From a depth history: the rays that reach their bitwise fixed
        point, and the share of march steps that leaving there saves, ray by
        ray and warp by warp when the test comes every 1, 2, 4 or 8 steps, for
        the frame's order and the shuffled one."""
        n = store.shape[0]
        steps = this.raymarch.settled_steps(store)
        settled = steps < n - 1
        need = torch.clamp(steps + 1, max=n - 1)
        report = {"rays": int(steps.numel()), "settled_rays": int(settled.sum()),
                  "mean_settled_step": float(steps[settled].float().mean()),
                  "ray_steps_saved_share": float(1 - need.sum() / (need.numel() * (n - 1)))}
        for what, s_ in (("in_order", steps), ("shuffled", steps[order])):
            for every in (1, 2, 4, 8):
                w = this.raymarch.warp_march_steps(s_, n, every)
                report[f"warp_steps_saved_share_{what}_every_{every}"] = float(
                    1 - w.sum() / (w.numel() * (n - 1)))
        return report

    with torch.no_grad():
        rk = this.rk
        gen = torch.Generator(device="cuda").manual_seed(17)
        order = torch.randperm(WIDTH * HEIGHT, device="cuda", generator=gen)
        for name in programs["this"]:
            view = views.get(name, views["sphere_repeat"])
            ro, rd = this.camera.camera_rays(WIDTH, HEIGHT, view, cfg.vfov_degrees, cfg.near,
                                             cfg.far)
            rays = [c.contiguous().view(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
            shuffled = [r[order].contiguous() for r in rays]
            v19 = rk.view19(view, cfg)
            params = this.compile.flat_params(scenes["this"][name]).contiguous()
            for label, p in packages.items():
                other = p.compile.flat_params(scenes[label][name]).contiguous()
                if not torch.equal(other, params):
                    raise RuntimeError(f"{label}: the {name} parameters differ from this "
                                       f"checkout's")
            gen = torch.Generator(device="cuda").manual_seed(5)
            cot = 1e-6 * torch.randn((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
            fwd = lib_of("this", "fwd", name)
            depth = rk.launch(fwd, params, v19, cfg, False)
            hits = int((depth <= cfg.far).sum())
            rgb = rk.launch(fwd, params, v19, cfg, True)
            _, store = rk.launch(lib_of("this", "fwd_store", name), params, v19, cfg, True,
                                 want_store=True)
            _, hit = rk.launch_rays(lib_of("this", "rays_fwd", name), params, rays, cfg, True,
                                    want_hit=True)
            say("frame", scene=name, hit_pixels=hits, hit_rays=int(hit.sum()),
                pixels=WIDTH * HEIGHT,
                frame_sha256=hashlib.sha256(rgb.cpu().numpy().tobytes()).hexdigest(),
                gradient=rk.launch_bwd(lib_of("this", "bwd", name), params, v19, cfg, True,
                                       cot).tolist())
            say("settle", scene=name, iterations=cfg.depth_iterations,
                **settle_report(store, order))

            # The forwards, bit for bit against the reference build.
            checks = [(cfg, True)]
            if name == "sphere_repeat":
                checks += [(this.st.RenderConfig(WIDTH, HEIGHT, depth_iterations=i), False)
                           for i in (80, 130)]
            for c, with_order in checks:
                o = order if with_order else None
                ref = forward_outputs(ref_label, name, params, v19, c, rays, o)
                ref_bands = band_outputs(ref_label, name, params, v19, c)
                for label in packages:
                    got = forward_outputs(label, name, params, v19, c, rays, o)
                    verdict = compare(got, ref, o)
                    del got
                    bands = band_outputs(label, name, params, v19, c)
                    b0 = 0
                    for k, ((b_rgb, b_store), (r_rgb, r_store)) in enumerate(zip(bands,
                                                                                ref_bands)):
                        bn = b_rgb.shape[0]
                        verdict[f"band{k}_rgb"] = same_bits(b_rgb, r_rgb)
                        verdict[f"band{k}_store"] = same_bits(b_store, r_store)
                        verdict[f"band{k}_store_vs_frame_columns"] = same_bits(
                            b_store, ref["store"][:, b0:b0 + bn])
                        b0 += bn
                    del bands
                    say("forward", scene=name, iterations=c.depth_iterations, package=label,
                        against=ref_label, bit_identical=all(verdict.values()), outputs=verdict)
                del ref, ref_bands
                torch.cuda.empty_cache()

            runs = {}
            for label in packages:
                rk_u = packages[label].rk
                f_lib, s_lib, r_lib = (lib_of(label, f, name) for f in FWD_FAMILIES)
                runs[f"{label} image forward"] = (
                    lambda rk_u=rk_u, f_lib=f_lib: rk_u.launch(f_lib, params, v19, cfg, True))
                runs[f"{label} forward with store"] = (
                    lambda rk_u=rk_u, s_lib=s_lib: rk_u.launch(s_lib, params, v19, cfg, True,
                                                               want_store=True))
                runs[f"{label} ray forward"] = (
                    lambda rk_u=rk_u, r_lib=r_lib: rk_u.launch_rays(r_lib, params, rays, cfg,
                                                                    True))
                runs[f"{label} ray forward with hit flags"] = (
                    lambda rk_u=rk_u, r_lib=r_lib: rk_u.launch_rays(r_lib, params, rays, cfg,
                                                                    True, want_hit=True))
                runs[f"{label} ray forward shuffled"] = (
                    lambda rk_u=rk_u, r_lib=r_lib: rk_u.launch_rays(r_lib, params, shuffled,
                                                                    cfg, True))
            outputs = {}
            for label, p in packages.items():
                bwd = lib_of(label, "bwd", name)
                fed = lib_of(label, "bwd_store", name)
                rays_lib = lib_of(label, "rays_bwd", name)
                runs[f"{label} image backward"] = (
                    lambda p=p, bwd=bwd: p.rk.launch_bwd(bwd, params, v19, cfg, True, cot))
                runs[f"{label} store-fed backward"] = (
                    lambda p=p, fed=fed: p.rk.launch_bwd(fed, params, v19, cfg, True, cot,
                                                         store=store))
                runs[f"{label} ray backward"] = rays_bwd(label, rays_lib, params, rays, cot, hit)
                outputs[label] = {k: runs[f"{label} {k}"]() for k in
                                  ("image backward", "store-fed backward", "ray backward")}
            runs["this ray backward without hit flags"] = rays_bwd(
                "this", lib_of("this", "rays_bwd", name), params, rays, cot, None)
            for label in packages:
                if label == "this":
                    continue
                for what in ("image backward", "store-fed backward", "ray backward"):
                    got, ref = outputs[label][what], outputs["this"][what]
                    got, ref = (got[0], ref[0]) if what == "ray backward" else (got, ref)
                    say("same", scene=name, what=what, against=label,
                        bit_identical=bool(torch.equal(got, ref)),
                        largest_difference_of_largest_entry=float(
                            (got - ref).abs().max() / ref.abs().max()))
            times = {k: [] for k in runs}
            order_of_runs = [*runs, *reversed(runs)]
            for k in order_of_runs + order_of_runs:
                times[k].append(events(runs[k]))
            for k, v in times.items():
                say("time", scene=name, variant=k, ms=float(np.mean(v)), rounds=v)
            del store, outputs
            torch.cuda.empty_cache()
    return 0


def tier_sweep(pkg, counts, say, events) -> int:
    """The image backward of ``union_grid_scene(n)`` for each n in both
    tiers, built in parallel, then timed in turns (there and back)."""
    import torch

    comp = pkg.compile
    programs = {}
    for n in counts:
        expr = pkg.scenes.union_grid_scene(n)
        for large, slots in ((False, 10**9), (True, 0)):
            comp.LARGE_SCENE_SLOTS = slots
            programs[(n, large)] = (expr, comp.trace(expr))
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        libs = dict(zip(programs, pool.map(lambda k: pkg.build.load_family(programs[k][1], "bwd"),
                                           programs)))
    view = pkg.st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = pkg.st.RenderConfig(WIDTH, HEIGHT)
    v19 = pkg.rk.view19(view, cfg)
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.rand((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
    runs = {}
    for key, (expr, _) in programs.items():
        params = pkg.compile.flat_params(expr).detach().contiguous()
        runs[key] = (lambda lib=libs[key], params=params:
                     pkg.rk.launch_bwd(lib, params, v19, cfg, True, cot))
    times = {k: [] for k in runs}
    with torch.no_grad():
        for k in [*runs, *reversed(runs)]:
            times[k].append(events(runs[k]))
        for (n, large), lib in libs.items():
            same = None
            if large:
                small, big = runs[(n, False)](), runs[(n, True)]()
                same = float((small - big).abs().max() / small.abs().max())
            say("tier", spheres=n, parameter_slots=programs[(n, large)][1].n_params,
                tier="large" if large else "small", nvcc_seconds=lib.build_seconds,
                registers=lib.registers, local_memory=lib.local_memory,
                resident_blocks_per_sm=lib.resident(1), ms=sum(times[(n, large)]) / 2,
                rounds=times[(n, large)], large_vs_small_of_largest_entry=same)
    return 0


def edited_csrc(pkg, work: pathlib.Path, name: str, edits) -> pathlib.Path:
    """A copy of the package's ``csrc/`` under ``work`` with ``edits`` made:
    each ``(file, old, new)`` replaces text that is there exactly once."""
    import shutil

    dest = work / f"csrc_{name}"
    shutil.copytree(pkg.build.CSRC, dest)
    for file, old, new in edits:
        text = (dest / file).read_text()
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to replace in {file} is not there once")
        (dest / file).write_text(text.replace(old, new))
    return dest


def build_variants(pkg, work: pathlib.Path, jobs: dict) -> dict:
    """key -> the library of ``jobs[key] = (program, family, csrc dir)``, or
    the compiler's error as a string: one nvcc each, all in parallel, into
    ``work``."""
    build = pkg.build

    def compile_one(item):
        key, (prog, family, csrc) = item
        stem = "_".join(map(str, key))
        (work / f"{stem}.cu").write_text(build.translation_unit(prog, family))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(csrc), "-o",
               str(work / f"{stem}.so"), str(work / f"{stem}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            return key, f"nvcc failed ({proc.returncode}): {proc.stderr[-3000:]}"
        seconds = time.perf_counter() - t0
        fam = build.FAMILIES[family]
        cdll = ctypes.CDLL(str(work / f"{stem}.so"))
        fn = getattr(cdll, fam.prefix + "_launch")
        fn.restype, fn.argtypes = ctypes.c_int, list(fam.argtypes)
        resident = getattr(cdll, fam.prefix + "_resident")
        resident.restype, resident.argtypes = ctypes.c_int, [ctypes.c_int]
        rows = None
        if fam.adjoint:
            rows = getattr(cdll, fam.prefix + "_rows")
            rows.restype, rows.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int]
        registers, local = build._ptxas(proc.stdout + proc.stderr)
        return key, build.KernelLib(launch=fn, path=work / f"{stem}.so", build_seconds=seconds,
                                    registers=registers, local_memory=local, rows=rows,
                                    store=fam.store, resident=resident)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return dict(pool.map(compile_one, jobs.items()))


def turns(runs: dict, events) -> dict:
    """Device ms of each of ``runs`` (key -> call), timed in turns there and
    back: key -> [first round, second round]."""
    times = {k: [] for k in runs}
    for k in [*runs, *reversed(runs)]:
        times[k].append(events(runs[k]))
    return times


def budget_sweep(pkg, budgets, say, events) -> int:
    """The large tier's image backward and store-fed backward of the
    200-sphere union at each register budget (resident blocks an SM), each
    built from a copy of ``csrc/`` with the constant edited, into a build
    directory of its own, in parallel; then timed in turns."""
    import shutil
    import tempfile

    import torch

    build = pkg.build
    expr = pkg.scenes.union_grid_scene()
    prog = pkg.compile.compile_scene(expr)
    work = pathlib.Path(tempfile.mkdtemp(prefix="budgets"))
    pattern = "constexpr int kBwdLargeMinBlocks = SDF_STORE ? 8 : 16;"
    jobs = {}
    for k in budgets:  # the same budget for the replay and the store-fed build
        csrc = edited_csrc(pkg, work, f"b{k}", [("raymarch_reduce.cuh", pattern,
                                                 f"constexpr int kBwdLargeMinBlocks = {k};")])
        jobs.update({(k, f): (prog, f, csrc) for f in ("bwd", "bwd_store")})
    libs = build_variants(pkg, work, jobs)
    failed = {k: v for k, v in libs.items() if isinstance(v, str)}
    if failed:
        raise RuntimeError(f"budget builds failed: {failed}")
    view = pkg.st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = pkg.st.RenderConfig(WIDTH, HEIGHT)
    v19 = pkg.rk.view19(view, cfg)
    params = pkg.compile.flat_params(expr).detach().contiguous()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.rand((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
    with torch.no_grad():
        _, store = pkg.rk.launch(build.load(prog, store=True), params, v19, cfg, True,
                                 want_store=True)
        runs = {key: (lambda lib=lib, key=key: pkg.rk.launch_bwd(
                    lib, params, v19, cfg, True, cot, store=store if key[1] == "bwd_store" else None))
                for key, lib in libs.items()}
        times = turns(runs, events)
    for (k, family), lib in libs.items():
        say("budget", blocks=k, family=family, nvcc_seconds=lib.build_seconds,
            registers=lib.registers, local_memory=lib.local_memory,
            resident_blocks_per_sm=lib.resident(1), ms=sum(times[(k, family)]) / 2,
            rounds=times[(k, family)])
    shutil.rmtree(work, ignore_errors=True)
    return 0


# The large tier's image backward with its sums elsewhere than the kernels'
# row a warp in device memory (``--rows``): a block's one row in shared
# memory, its warps' lane 0 adding with shared atomics (the order of the
# warps' adds is not fixed), or a row a warp in shared memory; either way the
# block writes one row of partials at its end, summing its warps' rows in
# order.
_ROWS_BEFORE = """  const int lane = threadIdx.x & 31;
  float* row = partials + ((long long)blockIdx.x * kBwdWarps + (threadIdx.x >> 5)) * kNOut;
"""
_ROWS_AFTER = """  const int lane = threadIdx.x & 31;
  __shared__ float shared_rows[kSharedRows * kNOut];
  for (int j = threadIdx.x; j < kSharedRows * kNOut; j += blockDim.x) shared_rows[j] = 0.0f;
  __syncthreads();
  float* row = shared_rows + (kSharedRows == 1 ? 0 : (threadIdx.x >> 5)) * kNOut;
"""
_ROWS_END_BEFORE = """    if (lane == 0) row[SDF_N_PARAMS + j] = v;
  }
}
#endif
"""
_ROWS_END_AFTER = """    if (lane == 0) atomicAdd(row + SDF_N_PARAMS + j, v);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < kNOut; j += blockDim.x) {
    float s = 0.0f;
    for (int w = 0; w < kSharedRows; ++w) s += shared_rows[w * kNOut + j];
    partials[(long long)blockIdx.x * kNOut + j] = s;
  }
}
#endif
"""
ROW_PLACES = ("warp_device", "block_shared", "warp_shared")


def rows_jobs(pkg, work: pathlib.Path) -> dict:
    """``--rows``: the 200-sphere union's image backward with each of
    ``ROW_PLACES`` for its sums, at the kernels' register budget."""
    prog = pkg.compile.compile_scene(pkg.scenes.union_grid_scene())
    jobs = {("rows", "warp_device"): (prog, "bwd", pkg.build.CSRC)}
    for place, count in (("block_shared", "1"), ("warp_shared", "kBwdWarps")):
        csrc = edited_csrc(pkg, work, place, [
            ("raymarch_reduce.cuh", "constexpr int kRowsPerBlock = SDF_LARGE ? kBwdWarps : 1;",
             f"constexpr int kRowsPerBlock = 1;\nconstexpr int kSharedRows = {count};"),
            ("raymarch_bwd.cu", _ROWS_BEFORE, _ROWS_AFTER),
            ("raymarch_bwd.cu", _ROWS_END_BEFORE, _ROWS_END_AFTER)])
        jobs[("rows", place)] = (prog, "bwd", csrc)
    return jobs


def rows_sweep(pkg, libs, say, events) -> None:
    """Times ``rows_jobs``' libraries in turns at 1920x1080x40 and holds each
    against the kernels' (the largest difference over the largest entry) and
    against itself launch to launch (bit for bit)."""
    import torch

    expr = pkg.scenes.union_grid_scene()
    view = pkg.st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = pkg.st.RenderConfig(WIDTH, HEIGHT)
    v19 = pkg.rk.view19(view, cfg)
    params = pkg.compile.flat_params(expr).detach().contiguous()
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.rand((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
    built = {place: libs[("rows", place)] for place in ROW_PLACES}
    for place, lib in built.items():
        if isinstance(lib, str):
            say("rows", place=place, error=lib)
    built = {p: lib for p, lib in built.items() if not isinstance(lib, str)}
    runs = {p: (lambda lib=lib: pkg.rk.launch_bwd(lib, params, v19, cfg, True, cot))
            for p, lib in built.items()}
    with torch.no_grad():
        times = turns(runs, events)
        ref = runs["warp_device"]() if "warp_device" in runs else None
        for place, lib in built.items():
            first, second = runs[place](), runs[place]()
            say("rows", place=place, nvcc_seconds=lib.build_seconds, registers=lib.registers,
                local_memory=lib.local_memory, resident_blocks_per_sm=lib.resident(1),
                ms=sum(times[place]) / 2, rounds=times[place],
                launch_to_launch_bit_identical=bool(torch.equal(first, second)),
                vs_warp_device_of_largest_entry=None if ref is None else float(
                    (first - ref).abs().max() / ref.abs().max()))


# The forward's six taps (``--taps``): straight-line, the six evaluations
# side by side, or a loop over the three axes.
_TAPS_IF = "#if SDF_LARGE\n  // A scene of the large tier"
TAP_FORMS = {"straight": "#if 0\n  // A scene of the large tier",
             "loop": "#if 1\n  // A scene of the large tier"}


def taps_jobs(pkg, work: pathlib.Path, counts) -> dict:
    """``--taps N ...``: the image forward of SphereRepeat and of
    ``union_grid_scene(N)`` for each N, with each of ``TAP_FORMS``."""
    scenes = {"sphere_repeat": pkg.scenes.sphere_repeat_scene(),
              **{f"union{n}": pkg.scenes.union_grid_scene(n) for n in counts}}
    jobs = {}
    for form, text in TAP_FORMS.items():
        csrc = edited_csrc(pkg, work, f"taps_{form}", [("raymarch_fwd.cuh", _TAPS_IF, text)])
        for name, expr in scenes.items():
            jobs[("taps", name, form)] = (pkg.compile.compile_scene(expr), "fwd", csrc)
    return jobs


def taps_sweep(pkg, libs, counts, say, events) -> None:
    """Times ``taps_jobs``' RGB forwards in turns at 1920x1080x40 (SphereRepeat
    from bench.py's camera, the unions from the default one) and holds the
    two forms' frames bit for bit."""
    import torch

    scenes = {"sphere_repeat": (pkg.scenes.sphere_repeat_scene(), (-2.0, 2.0, 4.0)),
              **{f"union{n}": (pkg.scenes.union_grid_scene(n), (0.0, 0.0, 5.0)) for n in counts}}
    cfg = pkg.st.RenderConfig(WIDTH, HEIGHT)
    with torch.no_grad():
        for name, (expr, eye) in scenes.items():
            v19 = pkg.rk.view19(pkg.st.look_at(eye, (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)), cfg)
            params = pkg.compile.flat_params(expr).detach().contiguous()
            built = {form: libs[("taps", name, form)] for form in TAP_FORMS}
            if any(isinstance(lib, str) for lib in built.values()):
                say("taps", scene=name, error={f: lib for f, lib in built.items()
                                               if isinstance(lib, str)})
                continue
            runs = {form: (lambda lib=lib: pkg.rk.launch(lib, params, v19, cfg, True))
                    for form, lib in built.items()}
            times = turns(runs, events)
            frames = {form: run() for form, run in runs.items()}
            same = bool(torch.equal(frames["straight"].view(torch.int32),
                                    frames["loop"].view(torch.int32)))
            for form, lib in built.items():
                say("taps", scene=name, parameter_slots=pkg.compile.compile_scene(expr).n_params,
                    form=form, nvcc_seconds=lib.build_seconds, registers=lib.registers,
                    local_memory=lib.local_memory, resident_blocks_per_sm=lib.resident(1),
                    ms=sum(times[form]) / 2, rounds=times[form], frames_bit_identical=same)


def _sass_size(sass, lib) -> dict | None:
    """The RGB kernel's SASS instructions and bytes (16 an instruction), and
    its loops' instructions, own instructions and square roots."""
    parsed = sass.library_sass(lib.path)
    if parsed is None:
        return None
    rgb = parsed["rgb"]
    return {"instructions": rgb["instructions"], "bytes": 16 * rgb["instructions"],
            "loops": [[lp["instructions"], lp["own"], lp["rsq"]] for lp in rgb["loops"]]}


# The three adjoints of the large tier, in the order the compiler writes them.
ADJOINTS = ("sdf_dist_vjp", "sdf_dist_vjp_pair", "sdf_eval_vjp")
_COUNTERS = """
__device__ unsigned long long sdf_probe_counts[12];
extern "C" int sdf_probe_counts_read(unsigned long long* out, int reset) {
  cudaError_t err = cudaMemcpyFromSymbol(out, sdf_probe_counts, sizeof(sdf_probe_counts));
  if (err == cudaSuccess && reset) {
    unsigned long long zero[12] = {0};
    err = cudaMemcpyToSymbol(sdf_probe_counts, zero, sizeof(zero));
  }
  return (int)err;
}
"""


def counted_adjoint(source: str) -> str:
    """The large tier's adjoint ``source`` with counters of its unions'
    pullbacks (``--loops``): per adjoint f (``ADJOINTS``), at
    ``sdf_probe_counts[4 f + c]``, the warp-calls in which some lane's point
    takes a cotangent at the union (c = 0), those of them that take the
    tree's rule at a tie (1), and the passes of a child's adjoint outside
    that rule (2) and in it (3); lane 0 counts for the warp."""
    import re

    include = '#include "raymarch_sums.cuh"\n'
    if include not in source or "_x = sdf_any(" not in source:
        raise ValueError("no union pulled back as a loop in this adjoint")
    starts = [source.index(f" {name}(") for name in ADJOINTS]
    out, at = [], 0
    for line in source.splitlines(keepends=True):
        out.append(line)
        at += len(line)
        f = sum(at > s for s in starts) - 1
        m = re.match(r"(\s*)const bool (L\d+)_x = sdf_any\(", line)
        if m:
            pad, tag = m.groups()
            pending = " || ".join(sorted(set(re.findall(rf"bool ({tag}_m\w*) = ",
                                                        "".join(out[-40:])))))
            out.append(f"#ifdef __CUDA_ARCH__\n{pad}if (__any_sync(0xffffffffu, {pending}) && "
                       f"(threadIdx.x & 31) == 0) {{ atomicAdd(sdf_probe_counts + {4 * f}, 1ull); "
                       f"if ({tag}_x) atomicAdd(sdf_probe_counts + {4 * f + 1}, 1ull); }}\n"
                       "#endif\n")
        m = re.match(r"(\s*)const float\* __restrict__ (L\d+)_K = ", line)
        if m:
            pad, tag = m.groups()
            out.append(f"#ifdef __CUDA_ARCH__\n{pad}if ((threadIdx.x & 31) == 0) "
                       f"atomicAdd(sdf_probe_counts + {4 * f} + ({tag}_x ? 3 : 2), 1ull);\n"
                       "#endif\n")
    return "".join(out).replace(include, include + _COUNTERS, 1)


def loops_sweep(packages, counts, say, events) -> int:
    """The forwards of ``union_grid_scene(n)`` of every package for each n
    (this checkout's in the loop form at every n), all six families at the
    largest n, and this checkout's variants there (``unroll2``, or
    ``unroll1`` where the loops are unrolled by 2: the forward and the image
    backward with the other unroll; ``constant``: the forward reading the
    parameters from the constant bank); all built in parallel, then timed in
    turns. The
    SASS is read of the forwards alone: a large backward's listing (hundreds
    of thousands of instructions, thousands of loops) takes
    ``sass.parse_sass`` minutes."""
    import dataclasses
    import shutil
    import tempfile

    import torch

    this = packages["this"]
    this.compile.LOOP_MIN_CHILDREN = 2
    top = max(counts)
    exprs = {(label, n): p.scenes.union_grid_scene(n) for label, p in packages.items()
             for n in counts}
    programs = {key: packages[key[0]].compile.compile_scene(e) for key, e in exprs.items()}
    jobs = [(label, n, "fwd") for label, n in programs]
    jobs += [(label, top, f) for label in packages for f in this.build.FAMILIES if f != "fwd"]
    jobs += [("this", n, "bwd") for n in counts if n != top]
    work = pathlib.Path(tempfile.mkdtemp(prefix="loops"))
    prog = programs[("this", top)]
    shared = "#define SDF_SHARED_PARAMS 1"
    pragma = f"#pragma unroll {this.compile.LOOP_UNROLL}\n"
    if pragma not in prog.source or shared not in prog.source:
        raise RuntimeError(f"union_grid_scene({top}) has no loop in shared memory")
    other = 2 if this.compile.LOOP_UNROLL != 2 else 1
    unrolled = dataclasses.replace(prog, source=prog.source.replace(
        pragma, f"#pragma unroll {other}\n"))
    constant = dataclasses.replace(prog, source=prog.source.replace(shared, shared[:-1] + "0"))
    variant_jobs = {(f"unroll{other}", top, f): (unrolled, f, this.build.CSRC)
                    for f in ("fwd", "bwd")}
    variant_jobs[("constant", top, "fwd")] = (constant, "fwd", this.build.CSRC)
    for n in counts:
        if n != top:  # the same program with its adjoints straight-line
            p_n = programs[("this", n)]
            variant_jobs[("straight_adjoint", n, "bwd")] = (dataclasses.replace(
                p_n, adjoint_source=this.compile.emit_large_vjp_cpp(
                    dataclasses.replace(p_n, loops=()))), "bwd", this.build.CSRC)
    counted = dataclasses.replace(prog, adjoint_source=counted_adjoint(prog.adjoint_source))
    variant_jobs[("counted", top, "bwd")] = (counted, "bwd", this.build.CSRC)

    def load(job):
        label, n, family = job
        return packages[label].build.load_family(programs[(label, n)], family)

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        variants = pool.submit(build_variants, this, work, variant_jobs)
        libs = dict(zip(jobs, pool.map(load, jobs)))
        variants = variants.result()
    failed = {k: v for k, v in variants.items() if isinstance(v, str)}
    if failed:
        raise RuntimeError(f"variant builds failed: {failed}")
    view = this.st.look_at((0.0, 0.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = this.st.RenderConfig(WIDTH, HEIGHT)
    v19 = this.rk.view19(view, cfg)
    ro, rd = this.camera.camera_rays(WIDTH, HEIGHT, view, cfg.vfov_degrees, cfg.near, cfg.far)
    rays = [c.contiguous().view(-1) for c in (ro.x, ro.y, ro.z, rd.x, rd.y, rd.z)]
    gen = torch.Generator(device="cuda").manual_seed(5)
    cot = torch.rand((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
    params = {key: packages[key[0]].compile.flat_params(e).detach().contiguous()
              for key, e in exprs.items()}
    with torch.no_grad():
        top_params = params[("this", top)]
        _, store = this.rk.launch(libs[("this", top, "fwd_store")], top_params, v19, cfg, True,
                                  want_store=True)
        _, hit = this.rk.launch_rays(libs[("this", top, "rays_fwd")], top_params, rays, cfg, True,
                                     want_hit=True)

    def call(rk, lib, prm, family):
        if family == "fwd":
            return lambda: rk.launch(lib, prm, v19, cfg, True)
        if family == "fwd_store":
            return lambda: rk.launch(lib, prm, v19, cfg, True, want_store=True)[0]
        if family == "rays_fwd":
            return lambda: rk.launch_rays(lib, prm, rays, cfg, True)
        if family == "bwd":
            return lambda: rk.launch_bwd(lib, prm, v19, cfg, True, cot)
        if family == "bwd_store":
            return lambda: rk.launch_bwd(lib, prm, v19, cfg, True, cot, store=store)
        return lambda: rk.launch_rays_bwd(lib, prm, rays, cfg, True, cot, hit=hit)[0]

    runs = {key: call(packages[key[0]].rk, libs[key], params[key[:2]], key[2]) for key in jobs}
    for (name, n, family), lib in variants.items():
        if name != "counted":  # its counters would slow it: run apart, below
            runs[(name, n, family)] = call(this.rk, lib, params[("this", n)], family)
    ref_label = next((label for label in packages if label != "this"), "this")
    with torch.no_grad():
        times = turns(runs, events)
        outputs = {key: run() for key, run in runs.items()}
        counted_lib = variants[("counted", top, "bwd")]
        read = ctypes.CDLL(str(counted_lib.path)).sdf_probe_counts_read
        read.restype, read.argtypes = ctypes.c_int, [ctypes.c_void_p, ctypes.c_int]
        tally = (ctypes.c_ulonglong * 12)()
        read(tally, 1)
        counted_out = call(this.rk, counted_lib, top_params, "bwd")()
        torch.cuda.synchronize()
        if read(tally, 0) != 0:
            raise RuntimeError("could not read the counted build's counters")
    per = {}
    for f, name in enumerate(ADJOINTS):
        calls, ties, passes, tie_passes = tally[4 * f:4 * f + 4]
        per[name] = {"warp_calls": calls, "tie_warp_calls": ties,
                     "tie_share": ties / calls if calls else None,
                     "passes_per_warp_call": passes / (calls - ties) if calls > ties else None,
                     "tie_passes_per_tie_warp_call": tie_passes / ties if ties else None}
    say("loops_counted", spheres=top, family="bwd", adjoints=per,
        bit_identical_to_uncounted=bool(torch.equal(
            counted_out.view(torch.int32), outputs[("this", top, "bwd")].view(torch.int32))))

    def reference(key):
        """The output ``key``'s is held to: the first --against package's, or
        below the largest N the image backward of the other adjoint form."""
        label, n, family = key
        if (ref_label, n, family) in outputs:
            return outputs[(ref_label, n, family)]
        return outputs[("straight_adjoint" if label == "this" else "this", n, family)]

    for key in runs:
        label, n, family = key
        lib = variants.get(key) or libs[key]
        ref, got = reference(key), outputs[key]
        ms = sum(times[key]) / len(times[key])
        prog_n = programs.get((label, n)) or programs[("this", n)]
        say("loops_variant" if key in variants else "loops", package=label,
            spheres=n, family=family, parameter_slots=prog_n.n_params,
            looped=list(getattr(prog_n, "looped", (0, 0.0))), ms=ms, ms_per_sphere=ms / n,
            rounds=times[key], nvcc_seconds=lib.build_seconds, registers=lib.registers,
            local_memory=lib.local_memory, resident_blocks_per_sm=lib.resident(1),
            sass=None if "bwd" in family else _sass_size(this.sass, lib), against=ref_label,
            bit_identical=bool(torch.equal(got.view(torch.int32), ref.view(torch.int32))),
            largest_difference_of_largest_entry=float((got - ref).abs().max()
                                                      / ref.abs().max()))
    shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
