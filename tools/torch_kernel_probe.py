#!/usr/bin/env python3
"""Probe the sphere-trace CUDA kernels of sdfkit_tpu_torch on one GPU.

    python3 tools/torch_kernel_probe.py [--package-root DIR] [--tag NAME]

Builds the six kernel libraries for SphereRepeat (the image forward and
backward, their depth-history builds, the ray-batch pair) and prints, one
JSON object per line with ``"probe"`` naming it:

* ``build``: per library the registers, stack and spills ``ptxas -v``
  reported, the resident blocks per SM the occupancy calculator gives (where
  the library has that entry), and from ``cuobjdump -sass`` the instructions
  of each kernel and of each of its loops with their square roots,
  reciprocals and division range checks;
* ``time``: CUDA-event times of the forward and backward launches alone at
  1920x1080x40 on SphereRepeat (nearly every pixel hits) and on one sphere of
  radius 0.5 seen by the same camera (mostly sky), in turns, with a hash of
  each frame and the gradient of a seeded cotangent (``frame``), so that two
  commits can be held against each other.

``--package-root`` names a directory that holds another ``sdfkit_tpu_torch``
(an earlier commit unpacked beside this one) to probe instead; the SASS
reader always comes from this checkout. Every line carries ``--tag`` and the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
WIDTH, HEIGHT = 1920, 1080
WARMUP, TIMED = 3, 10


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package-root", default=str(ROOT))
    ap.add_argument("--tag", default="")
    args = ap.parse_args()
    sys.path.insert(0, args.package_root)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_probe: no CUDA device", file=sys.stderr)
        return 1
    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import scenes
    from sdfkit_tpu_torch.render.cuda import build
    from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk
    from sdfkit_tpu_torch.sdf.compile import compile_scene, flat_params, operation_counts

    # The SASS reader of this checkout, whatever package is probed.
    spec = importlib.util.spec_from_file_location(
        "probe_sass", ROOT / "sdfkit_tpu_torch" / "render" / "cuda" / "sass.py")
    sass = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sass)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()

    def say(probe, **fields):
        print(json.dumps({"probe": probe, "tag": args.tag, "gpu": smi, **fields}), flush=True)

    def events(fn) -> float:
        for _ in range(WARMUP):
            fn()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(TIMED):
            fn()
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / TIMED

    view = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0))
    cfg = st.RenderConfig(WIDTH, HEIGHT)
    frames = {"sphere_repeat": scenes.sphere_repeat_scene(), "one_sphere": st.sphere(0.5)}

    def rows(lib, count, want_color):
        try:
            return lib.rows(count, int(want_color))
        except TypeError:  # an earlier commit's entry takes the count alone
            return lib.rows(count)

    hero = compile_scene(frames["sphere_repeat"])
    roots = sum(hero.nodes[i][0] == "sqrt" for i in hero.dist_live)
    say("program", operations=operation_counts(hero), square_roots_per_distance=roots,
        divisions_per_distance=sum(hero.nodes[i][0] == "div" for i in hero.dist_live))
    for family in build.FAMILIES:
        lib = build.load_family(hero, family)
        resident = getattr(lib, "resident", None)
        say("build", family=family, nvcc_seconds=lib.build_seconds, registers=lib.registers,
            local_memory=lib.local_memory,
            resident_blocks_per_sm=None if resident is None else
            {"rgb": resident(1), "depth": resident(0)},
            sass=sass.library_sass(lib.path))

    inputs = {}
    for name, expr in frames.items():
        program = compile_scene(expr)
        with torch.no_grad():
            params = flat_params(expr).contiguous()
            v19 = rk.view19(view, cfg)
            gen = torch.Generator(device="cuda").manual_seed(5)
            cot = 1e-6 * torch.randn((WIDTH * HEIGHT, 3), device="cuda", generator=gen)
            depth = rk.launch(build.load(program), params, v19, cfg, False)
            hits = int((depth <= cfg.far).sum())
        inputs[name] = (program, params, v19, cot, hits)

    def time_all(what, runs):
        """``runs``: label -> callable; timed in turns, there and back."""
        times = {k: [] for k in runs}
        for k in [*runs, *reversed(runs)]:
            times[k].append(events(runs[k]))
        for k, v in times.items():
            say("time", what=what, variant=k, ms=float(np.mean(v)), rounds=v)

    with torch.no_grad():
        for name, (program, params, v19, cot, hits) in inputs.items():
            fwd, bwd = build.load(program), build.load_bwd(program)
            rgb = rk.launch(fwd, params, v19, cfg, True)
            say("frame", scene=name, hit_pixels=hits, pixels=WIDTH * HEIGHT,
                frame_sha256=hashlib.sha256(rgb.cpu().numpy().tobytes()).hexdigest(),
                gradient=rk.launch_bwd(bwd, params, v19, cfg, True, cot).tolist(),
                backward_grid=rows(bwd, WIDTH * HEIGHT, True), backward_registers=bwd.registers)
            runs = {
                "forward": lambda: rk.launch(fwd, params, v19, cfg, True),
                "backward": lambda: rk.launch_bwd(bwd, params, v19, cfg, True, cot),
            }
            time_all(name, runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
