"""Scaling harness for the port's row-sharded render, the counterpart of
``tools/scaling.py``.

Measures how the row-sharded render scales with the rank count. It times
the computation users run: ``parallel.train.build_sharded_render``'s
``(fn, args)``, the program ``render_sharded`` calls, on SphereRepeat.

    python tools/torch_scaling.py --devices 1 2 4 --width 1920 --height 1080
    python tools/torch_scaling.py --device cpu --backend torch --devices 1 2

The ranks are processes. Run as above, the tool spawns ``max(--devices)``
ranks itself (``tools/torch_distributed_demo.launch``, a ``file://``
rendezvous in a temporary directory). Under ``torchrun``, or with
``--init-method URL --world-size N --rank K`` on every rank, it joins that
group instead (the counterpart of ``--coordinator / --num-processes /
--process-id``). One group serves every point: n = 1 is the mesh of rank 0
alone (``distributed.single``, no collective), n > 1 a ``Mesh`` over
``torch.distributed.new_group(range(n))``; the ranks outside wait at a
barrier of the whole group. ``--process-group nccl`` puts rank r on card r
of the host (and refuses fewer cards than ranks), ``gloo`` every rank on the
current card; by default NCCL where the cards cover the ranks
(``distributed.default_backend``).

    python tools/torch_scaling.py --process-group nccl --devices 1 2 4 --width 3840 --height 2160

Each point reports:

1. **Wall clock**: one warm-up, then ``--reps`` times a barrier, the host
   clock, ``fn()``, a synchronise of the card and a barrier; the min. Where
   ranks share a card (``shared_device``: fewer distinct cards, by PCI
   address, than ranks) they take turns on it and the point measures the
   collectives, not a speed-up. ``walltime_efficiency_pct`` is the frame's
   Mrays/s at n over n times that at one rank.
2. **Work per rank, static**: the image forward's fixed work over the
   largest band (``render.cuda.work.frame_work``: nodes of the compiled
   program, not instructions, and the bytes of the band's output and the
   uniforms). ``work_partition_efficiency_pct`` is
   ops(1) / (n ops(n)), the JAX tool's formula.
3. **Band time alone**: each rank renders its band through the same row
   renderer once more while every other rank waits at a barrier, timed on
   the card with CUDA events (queued behind a sleep, so the host's work to
   launch it is not timed); ``band_efficiency_pct`` is
   band_ms(1) / (n max band_ms). This is how the JAX package's
   ``SCALING.json`` measured a real chip; on one card it stands in for n
   cards and shows the bands' imbalance.

Every point also holds its frame bit for bit to the frame of one rank and
counts each rank's image-forward launches per frame. The JSON goes to
standard output (and to ``--out`` when given); the tool exits 1 when a
frame differs. It runs on the card unless ``--device cpu`` asks for the CPU;
with no card it raises.
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

import torch  # noqa: E402

SLEEP_CYCLES = 40_000_000  # about 20 ms ahead of a timed band


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--iters", type=int, default=40)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--devices", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--backend", default="auto", choices=("auto", "kernel", "torch"),
                    help="render backend measured; 'auto' = the kernels for a scene on the "
                         "card, the plain path on the CPU")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks render: the card (raises without one) or the CPU")
    ap.add_argument("--process-group", choices=("gloo", "nccl"), default=None,
                    help="the ranks' backend: 'nccl' puts each rank on a card of its own (and "
                         "raises with fewer cards than ranks), 'gloo' every rank on the current "
                         "card; by default nccl where the cards cover the ranks")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds for the ranks (and their collectives)")
    ap.add_argument("--init-method", "--init", dest="init",
                    help="join this group (e.g. tcp://HOST:PORT) as one rank")
    ap.add_argument("--world-size", "--ranks", dest="world_size", type=int)
    ap.add_argument("--rank", type=int)
    # Passed by tools/torch_distributed_demo.launch to every worker: --worker
    # (report to the launcher), and two flags this tool does not read.
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    for flag in ("--size", "--scratch"):
        ap.add_argument(flag, help=argparse.SUPPRESS)
    return ap


class Rank:
    """This process's rank: its device, the scene and the render settings."""

    def __init__(self, a):
        import sdfkit_tpu_torch as st
        from sdfkit_tpu_torch import parallel as par
        from sdfkit_tpu_torch import scenes
        from sdfkit_tpu_torch.render.raymarch import RenderConfig, resolve_backend
        from sdfkit_tpu_torch.sdf.compile import compile_scene
        from sdfkit_tpu_torch.utils.camera import default_view

        if a.device == "cpu":
            st.set_default_device("cpu")
            torch.set_num_threads(1)
        kw = {k: v for k, v in (("world_size", a.world_size), ("rank", a.rank)) if v is not None}
        par.initialize(a.init, backend=a.process_group,
                       timeout=datetime.timedelta(seconds=a.timeout), **kw)
        world = par.make_mesh()  # this rank's device; raises on a rank with no card
        if a.device == "cuda" and world.device.type != "cuda":
            raise RuntimeError(f"rank {world.rank} is on {world.device}, not a card")
        self.a, self.world, self.device = a, world, world.device
        self.cuda = self.device.type == "cuda"
        self.scene = scenes.sphere_repeat_scene(self.device)
        self.cfg = RenderConfig(width=a.width, height=a.height, depth_iterations=a.iters)
        self.view = default_view(self.device)
        self.backend = resolve_backend(a.backend, self.scene)
        self.program = compile_scene(self.scene)
        self.sleep_ms = self._sleep_ms() if self.cuda else None

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.device)

    def _sleep_ms(self) -> float:
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ms = []
        for _ in range(2):
            start.record()
            torch.cuda._sleep(SLEEP_CYCLES)
            stop.record()
            torch.cuda.synchronize(self.device)
            ms.append(start.elapsed_time(stop))
        return ms[-1]

    def launches(self) -> int:
        from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk

        return rk.LAUNCHES

    def frame_ms(self, mesh, fn, args) -> tuple[torch.Tensor, list[float], float]:
        """(the frame, the timed ms, image-forward launches per call of fn)."""
        before = self.launches()
        self.sync()
        frame = fn(*args)
        self.sync()
        ms = []
        for _ in range(self.a.reps):
            mesh.barrier()
            self.sync()
            t0 = time.perf_counter()
            fn(*args)
            self.sync()
            mesh.barrier()
            ms.append((time.perf_counter() - t0) * 1e3)
        return frame, ms, (self.launches() - before) / (1 + self.a.reps)

    def band_ms(self, render, r0: int, count: int) -> float:
        """Min ms of this rank's band alone: CUDA events behind a sleep on
        the card, the host clock on the CPU."""
        ms = []
        with torch.no_grad():
            render(r0, count)
            for _ in range(self.a.reps):
                self.sync()
                if not self.cuda:
                    t0 = time.perf_counter()
                    render(r0, count)
                    ms.append((time.perf_counter() - t0) * 1e3)
                    continue
                start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
                torch.cuda._sleep(SLEEP_CYCLES)
                t0 = time.perf_counter()
                start.record()
                render(r0, count)
                stop.record()
                queued_ms = (time.perf_counter() - t0) * 1e3
                self.sync()
                if queued_ms >= self.sleep_ms:
                    raise RuntimeError(f"the host took {queued_ms:.3f} ms to queue a band, "
                                       f"longer than the {self.sleep_ms:.3f} ms sleep ahead of it")
                ms.append(start.elapsed_time(stop))
        return min(ms)


def run_rank(a) -> dict:
    """One rank: every point of ``--devices`` (up to the group's size).
    Returns the result on rank 0 (``result``), ``{"rank": r}`` elsewhere."""
    import torch.distributed as dist

    from sdfkit_tpu_torch.parallel import distributed
    from sdfkit_tpu_torch.parallel.train import band_rows, build_sharded_render, row_renderer
    from sdfkit_tpu_torch.render.cuda import build

    me = Rank(a)
    rank, world = me.world.rank, me.world.size
    dist.barrier()  # no rank's start-up shares the card with a timed point
    ref = None
    if rank == 0:  # the frame of one rank, which every point must equal
        fn, args = build_sharded_render(distributed.single(me.device), me.scene, me.view, me.cfg,
                                        backend=a.backend)
        ref = fn(*args)
    mine = []
    for n in [d for d in a.devices if d <= world]:
        # Every rank creates every group, in the same order.
        group = dist.new_group(list(range(n))) if n > 1 else None
        rec = None
        if rank < n:
            mesh = distributed.single(me.device) if n == 1 else distributed.Mesh(
                rank=rank, size=n, device=me.device, group=group, backend=me.world.backend)
            fn, args = build_sharded_render(mesh, me.scene, me.view, me.cfg, backend=a.backend)
            frame, ms, launches = me.frame_ms(mesh, fn, args)
            _, r0, count = band_rows(mesh, me.cfg.height)
            render = row_renderer(me.scene, me.view, me.cfg, me.backend)
            band = None
            for r in range(n):  # one band at a time; the others wait
                if r == rank:
                    band = me.band_ms(render, r0, count)
                mesh.barrier()
            rec = {"ms": ms, "launches_per_frame": launches, "band_ms": band}
            if rank == 0:
                rec["frame_equal_to_one_rank"] = bool(torch.equal(frame, ref))
                rec["frame_sha256"] = hashlib.sha256(
                    frame.cpu().numpy().tobytes()).hexdigest()
            del frame
        mine.append((n, rec))
        dist.barrier()
    every = [None] * world
    dist.all_gather_object(every, {"points": mine, "nvcc_builds": build.BUILDS,
                                   "device": distributed.card_id(me.device)})
    report = result(me, every) if rank == 0 else {"rank": rank}
    dist.barrier()
    dist.destroy_process_group()
    return report


def result(me: Rank, every: list[dict]) -> dict:
    """The JSON of every point, from every rank's records (on rank 0)."""
    from sdfkit_tpu_torch.render.cuda import work

    cfg = me.cfg
    per_pixel = work.fixed_operations_per_pixel(me.program, cfg.depth_iterations)
    cards = torch.cuda.device_count() if me.cuda else 0
    cores = os.cpu_count() or 1
    points = []
    for i, (n, rec0) in enumerate(every[0]["points"]):
        recs = [every[r]["points"][i][1] for r in range(n)]
        secs = min(rec0["ms"]) / 1e3
        band_pixels = min(cfg.height, -(-cfg.height // n)) * cfg.width
        band = work.frame_work(me.program, cfg.depth_iterations, band_pixels, 0, 0)["fwd_fixed"]
        points.append({
            "devices": n,
            "seconds": secs,
            "ms": rec0["ms"],
            "mrays_per_s": cfg.width * cfg.height / secs / 1e6,
            "per_device_operations": band.operations,
            "per_device_bytes": band.bytes,
            # On the card: ranks that render on fewer cards than there are
            # ranks; on the CPU: more ranks than cores.
            "shared_device": (len({every[r]["device"] for r in range(n)}) < n if me.cuda
                              else n > cores),
            "band_ms": [r["band_ms"] for r in recs],
            "launches_per_frame": [r["launches_per_frame"] for r in recs],
            "frame_equal_to_one_rank": rec0["frame_equal_to_one_rank"],
            "frame_sha256": rec0["frame_sha256"],
        })
    base = points[0]
    one = next((p for p in points if p["devices"] == 1), None)
    for p in points:
        n = p["devices"]
        p["walltime_efficiency_pct"] = 100.0 * p["mrays_per_s"] / (n * base["mrays_per_s"])
        p["work_partition_efficiency_pct"] = (
            100.0 * base["per_device_operations"] / (n * p["per_device_operations"]))
        p["band_efficiency_pct"] = (
            None if one is None else 100.0 * one["band_ms"][0] / (n * max(p["band_ms"])))
    return {
        "workload": {
            "scene": "SphereRepeat (Perf/Program.cs:5-22)",
            "width": cfg.width,
            "height": cfg.height,
            "depth_iterations": cfg.depth_iterations,
            "sharding": "image rows in bands of ceil(H / n) over the ranks of a "
                        "torch.distributed group",
            "program": "parallel.train.build_sharded_render (the shipped render_sharded path)",
        },
        "backend": me.device.type,
        "device_name": torch.cuda.get_device_name(me.device) if me.cuda else "cpu",
        "cards": cards,
        "process_group": me.world.backend,
        "render_backend": me.backend,
        "band_clock": "cuda events behind a sleep" if me.cuda else "host",
        "per_pixel_operations": per_pixel,
        "host_cores": cores,
        "num_processes": me.world.size,
        "nvcc_builds": [e["nvcc_builds"] for e in every],
        "rank_devices": [e["device"] for e in every],
        "points": points,
    }


def main(argv=None) -> int:
    a = parser().parse_args(argv)
    from sdfkit_tpu_torch.parallel.distributed import _cluster_env_present

    if a.init is not None or _cluster_env_present():
        out = run_rank(a)
        if a.worker:  # spawned by the launcher below, which reads this line
            print("REPORT " + json.dumps(out), flush=True)
            return 0
        if "points" not in out:  # not rank 0
            return 0
    else:
        import torch_distributed_demo as demo
        from sdfkit_tpu_torch.parallel.distributed import require_cards

        if a.process_group == "nccl":
            require_cards(max(a.devices))
        worker_args = ["--width", str(a.width), "--height", str(a.height), "--iters",
                       str(a.iters), "--reps", str(a.reps), "--backend", a.backend,
                       "--devices", *(str(d) for d in a.devices)]
        if a.process_group:
            worker_args += ["--process-group", a.process_group]
        out = demo.launch(max(a.devices), device=a.device, timeout=a.timeout,
                          worker=os.path.abspath(__file__), worker_args=worker_args)[0]
    text = json.dumps(out)
    if a.out:
        with open(a.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0 if all(p["frame_equal_to_one_rank"] for p in out["points"]) else 1


if __name__ == "__main__":
    sys.exit(main())
