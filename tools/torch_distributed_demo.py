"""The port's sharded paths over several processes (``torch.distributed``).

The counterpart of ``tools/distributed_demo.py`` for ``sdfkit_tpu_torch``:
it runs the checks of ``__graft_entry__.dryrun_multichip`` in N worker
processes, one rank each, against a mesh of one rank in the same process.

Run as the launcher, which spawns the workers on a ``file://`` rendezvous in
a temporary directory (no port to clash) and fails unless every rank passed:

    python tools/torch_distributed_demo.py --ranks 4 --size full      # the card
    python tools/torch_distributed_demo.py --ranks 4 --size cards --backend nccl  # 4 cards
    python tools/torch_distributed_demo.py --ranks 4 --device cpu     # CPU, gloo

``--size small`` (the CPU tests) renders 16x9 frames and meshes 16^3 grids;
``--size full`` is SphereRepeat at 1920x1080x40, a 4K depth frame, 256^3
and 512x128x128 grids, with times (``chip_smoke.py`` phase 19); ``--size
cards`` adds a 4K RGB frame and the bricks and the mesh at 512^3 (phase 23).
Ranks on one card share it in a ``gloo`` group (NCCL refuses two ranks on
one device); under ``--backend nccl`` rank r takes card r, and the launcher
refuses fewer cards than ranks before it spawns any. ``--backend``
overrides ``parallel.distributed.default_backend``.

What each rank checks, against the one-rank mesh (``distributed.single``):
``render_sharded`` RGB and depth bit for bit (and against ``RayMarcher``),
``train_step_sharded`` (loss rtol 1e-5, new leaves rtol 5e-5 / atol 5e-5,
the bound of ``dryrun_multichip``), ``fit(mesh=)`` (losses rtol 1e-3, and a
resume from rank 0's checkpoint), ``voxelize_sharded`` bit for bit against
``voxelize``, ``create_mesh_sharded`` array for array against ``to_mesh``,
and resumable tiles over the mesh bit for bit, then resumed on rank 0 alone.
``--out DIR`` keeps each rank's outputs (``rank<r>.npz``) and report
(``rank<r>.json``). The ranks run on the card unless ``--device cpu`` asks
for the CPU; a rank that finds no card raises. ``launch(worker=...)`` spawns
another program as each rank, one that calls :func:`run_worker` with its own
launch counts (the CPU tests' stand-ins for the kernels, which run both
routes on CPU tensors).
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SIZES = {
    "small": dict(width=16, height=9, train_height=7, vox=(8, 8, 9), grid=16, tile_rows=4,
                  fit_steps=2, times=False),
    "full": dict(width=1920, height=1080, train_height=1080, vox=(512, 128, 128), grid=256,
                 tile_rows=128, fit_steps=5, times=True, depth4k=(3840, 2160)),
}
# A card for each rank (chip_smoke.py phase 23): also a 4K RGB frame, and
# voxelize_sharded and create_mesh_sharded at 512^3.
SIZES["cards"] = dict(SIZES["full"], rgb4k=True, big_grid=512)
LEAF_RTOL = LEAF_ATOL = 5e-5  # dryrun_multichip's bound for the new leaves
LOSS_RTOL = 1e-5
FIT_RTOL = 1e-3
REPS = 5
COLLECTIVE_REPEAT = 20  # collectives timed back to back, per call


class Worker:
    """One rank's checks; ``report`` collects what the launcher reads."""

    def __init__(self, mesh, one, size: dict, host_calls):
        self.mesh, self.one, self.size = mesh, one, size
        self.cuda = mesh.device.type == "cuda"
        self.host_calls = host_calls
        self.report = {"rank": mesh.rank, "ranks": mesh.size, "backend": mesh.backend,
                       "device": str(mesh.device), "checks": [], "times": {}, "launches": {},
                       "errors": {}}
        if self.cuda:  # which card this is, beyond its index in this process
            from sdfkit_tpu_torch.parallel.distributed import card_id

            self.report["pci_bus_id"] = card_id(mesh.device)
        self.outputs = {}

    def check(self, ok: bool, what: str) -> None:
        print(f"rank {self.mesh.rank}: {'PASS' if ok else 'FAIL'} {what}", flush=True)
        self.report["checks"].append([bool(ok), what])

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def launches(self):
        """(image forward, image backward) launches so far on this rank."""
        if self.host_calls is not None:
            return self.host_calls["fwd"], self.host_calls["bwd"]
        from sdfkit_tpu_torch.render.cuda import raymarch_kernel as rk

        return rk.LAUNCHES, rk.BWD_LAUNCHES

    def count(self, name: str, fn):
        """``fn()``, with this rank's kernel launches during it recorded."""
        before = self.launches()
        self.sync()
        out = fn()
        self.sync()
        self.report["launches"][name] = [a - b for a, b in zip(self.launches(), before)]
        return out

    def timed(self, name: str, fn, one=None, repeat: int = 1) -> None:
        """Milliseconds of ``fn`` over the mesh (every rank between two
        barriers) and, beside it, of ``one`` on rank 0 alone while the others
        wait: host clock, the card synchronised at both ends. ``repeat``
        calls of ``fn`` back to back between the barriers give one sample,
        its ms over ``repeat``: a collective alone, without the barrier's
        own cost."""
        if not self.size["times"]:
            return
        ms = []
        for _ in range(REPS):
            self.mesh.barrier()
            self.sync()
            t0 = time.perf_counter()
            for _ in range(repeat):
                fn()
            self.sync()
            self.mesh.barrier()
            ms.append((time.perf_counter() - t0) * 1e3 / repeat)
        one_ms = []
        if one is not None and self.mesh.rank == 0:
            one()  # warm
            for _ in range(REPS):
                self.sync()
                t0 = time.perf_counter()
                one()
                self.sync()
                one_ms.append((time.perf_counter() - t0) * 1e3)
        self.mesh.barrier()
        self.report["times"][name] = {"ranks_ms": ms, "one_rank_ms": one_ms, "repeat": repeat}

    def keep(self, name: str, t) -> None:
        if isinstance(t, torch.Tensor):
            t = t.detach().cpu().numpy()
        self.outputs[name] = t


def _leaves_close(a, b):

    err = max(float(np.max(np.abs(x - y), initial=0.0)) for x, y in zip(a, b))
    ok = all(np.allclose(x, y, rtol=LEAF_RTOL, atol=LEAF_ATOL) for x, y in zip(a, b))
    return ok, err


def seeded_target(h: int, w: int, device):
    """An (h, w, 3) target image made with numpy from the seed ``h``."""

    rng = np.random.default_rng(h)
    return torch.from_numpy(rng.uniform(size=(h, w, 3)).astype(np.float32)).to(device)


def _flat(expr):

    import sdfkit_tpu_torch as st

    return [np.asarray(p.detach().cpu().numpy()) for p in st.leaves(expr)]


def run_checks(w: Worker, backend: str, tag: str, tmp: pathlib.Path) -> None:
    """Every check of one backend ('kernel' or 'torch'); output names take
    ``tag`` as a prefix."""

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch import scenes

    mesh, one, size = w.mesh, w.one, w.size
    r = mesh.rank
    W, H = size["width"], size["height"]
    # The hero view at full size (chip_smoke.py's frames); the dryrun's default
    # view at the small size, where the JAX package's results are compared.
    eye = st.look_at((-2.0, 2.0, 4.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0)) \
        if size["times"] else None
    hero = scenes.sphere_repeat_scene()
    what = f"[{backend} backend, {mesh.size} ranks]"

    # -- render_sharded: RGB, depth, and a small odd frame (a padded last band).
    for first, (w_, h_) in zip((True, False), ((W, H), (16, 2 * mesh.size + 1))):
        rgb = w.count(f"{tag}render_sharded_{w_}x{h_}",
                      lambda: par.render_sharded(mesh, hero, w_, h_, view=eye, backend=backend))
        depth = par.render_sharded(mesh, hero, w_, h_, view=eye, depth_only=True,
                                   backend=backend)
        with torch.no_grad():
            marcher = st.RayMarcher(w_, h_, hero, view=eye, backend=backend)
            ref_rgb, ref_depth = marcher.render(), marcher.render_depth()
        one_rgb = par.render_sharded(one, hero, w_, h_, view=eye, backend=backend)
        w.check(rgb.shape == (h_, w_, 3) and torch.equal(rgb, ref_rgb) and torch.equal(rgb, one_rgb),
                f"{what} render_sharded RGB {w_}x{h_} equals RayMarcher.render() and the "
                f"one-rank mesh bit for bit")
        w.check(torch.equal(depth, ref_depth),
                f"{what} render_sharded depth {w_}x{h_} equals RayMarcher.render_depth() bit for bit")
        if first:
            w.keep(f"{tag}render_rgb", rgb)
            w.keep(f"{tag}render_depth", depth)
            w.timed(f"{tag}render_sharded_{W}x{H}_ms",
                    lambda: par.render_sharded(mesh, hero, W, H, view=eye, backend=backend),
                    lambda: par.render_sharded(one, hero, W, H, view=eye, backend=backend))
        del rgb, depth, ref_rgb, ref_depth, one_rgb

    # -- train_step_sharded against a mesh of one.
    if size["times"]:  # the fit's frame: the radius moved from 0.5 to 0.55
        with torch.no_grad():
            target = st.RayMarcher(W, size["train_height"], hero, view=eye,
                                   backend=backend).render().clone()
        start = scenes.sphere_repeat_scene()
        with torch.no_grad():
            st.leaves(start)[0].fill_(0.55)
    else:  # dryrun_multichip's: a black target of an odd height
        target = torch.zeros((size["train_height"], W, 3), device=mesh.device)
        start = hero
    new, loss = w.count(f"{tag}train_step_sharded",
                        lambda: par.train_step_sharded(mesh, start, target, view=eye,
                                                       lr=1e-2, backend=backend))
    ref, ref_loss = par.train_step_sharded(one, start, target, view=eye, lr=1e-2, backend=backend)
    ok, err = _leaves_close(_flat(new), _flat(ref))
    loss_err = abs(loss.item() - ref_loss.item()) / abs(ref_loss.item())
    w.report["errors"][f"{tag}train_step_leaves_max_abs"] = err
    w.report["errors"][f"{tag}train_step_loss_rel"] = loss_err
    w.check(bool(torch.isfinite(loss)) and loss_err <= LOSS_RTOL and ok,
            f"{what} train_step_sharded {W}x{size['train_height']}: loss {loss.item():.7g} against "
            f"{ref_loss.item():.7g} on one rank (relative {loss_err:.3g}, bound {LOSS_RTOL}); new "
            f"leaves within rtol {LEAF_RTOL} / atol {LEAF_ATOL} (max abs {err:.3g})")
    w.keep(f"{tag}train_loss", np.float32(loss.item()))
    w.keep(f"{tag}train_leaves", np.concatenate([a.reshape(-1) for a in _flat(new)]))
    w.timed(f"{tag}train_step_sharded_{W}x{size['train_height']}_ms",
            lambda: par.train_step_sharded(mesh, start, target, view=eye, lr=1e-2,
                                           backend=backend),
            lambda: par.train_step_sharded(one, start, target, view=eye, lr=1e-2,
                                           backend=backend))

    # -- a palette's (T, 3) leaf through the gradient all-reduce (small size:
    #    its libraries are not among those the card's parent process built).
    if not size["times"]:
        pal = st.sphere(0.5).repeat_indexed("xy", (1.125, 1.125), [[0.9, 0.2, 0.2],
                                                                  [0.2, 0.9, 0.2]])
        tgt_p = seeded_target(H, W, mesh.device)
        p_new, p_loss = par.train_step_sharded(mesh, pal, tgt_p, view=eye, backend=backend)
        p_ref, p_ref_loss = par.train_step_sharded(one, pal, tgt_p, view=eye, backend=backend)
        ok, err = _leaves_close(_flat(p_new), _flat(p_ref))
        moved = not np.allclose(p_new.table.detach().cpu().numpy(), [[0.9, 0.2, 0.2],
                                                                     [0.2, 0.9, 0.2]])
        w.check(ok and moved
                and abs(p_loss.item() - p_ref_loss.item()) <= LOSS_RTOL * p_ref_loss.item(),
                f"{what} train_step_sharded of a palette scene: the (2, 3) table moves and "
                f"matches the one-rank step (max abs {err:.3g})")
        w.keep(f"{tag}pal_loss", np.float32(p_loss.item()))
        w.keep(f"{tag}pal_leaves", np.concatenate([a.reshape(-1) for a in _flat(p_new)]))

    # -- fit(mesh=) against fit on one rank, and a resume from rank 0's checkpoint.
    if size["times"]:
        fit_start, fit_target, fit_view = start, target, eye
        opt = dict(optimizer=lambda leaves: torch.optim.Adam([leaves[0]], lr=2e-3))
    else:  # tests/test_torch_fit.py's frame, on which the port and the JAX package agree
        fit_start, fit_view = st.sphere(0.7, color=(0.4, 0.4, 0.4)), None
        with torch.no_grad():
            fit_target = st.RayMarcher(24, 16, st.sphere(1.0, color=(0.8, 0.3, 0.2)),
                                       backend=backend).render()
        opt = dict(learning_rate=0.02)
        w.keep(f"{tag}fit_target", fit_target)
    steps = size["fit_steps"]
    res = w.count(f"{tag}fit_mesh", lambda: st.fit(fit_start, fit_target, steps=steps,
                                                   view=fit_view, mesh=mesh, backend=backend, **opt))
    res_one = st.fit(fit_start, fit_target, steps=steps, view=fit_view, backend=backend, **opt)
    ok = np.allclose(res.losses, res_one.losses, rtol=FIT_RTOL)
    w.check(ok and all(np.isfinite(res.losses)),
            f"{what} fit(mesh=) {steps} steps: losses {res.losses} against one rank's "
            f"{res_one.losses} (rtol {FIT_RTOL})")
    w.keep(f"{tag}fit_losses", np.asarray(res.losses, np.float32))
    ckpt = tmp / f"{tag}fit_ckpt"
    st.fit(fit_start, fit_target, steps=steps - 1, view=fit_view, mesh=mesh, backend=backend,
           checkpoint_dir=ckpt, checkpoint_every=1, **opt)
    resumed = st.fit(fit_start, fit_target, steps=steps, view=fit_view, mesh=mesh,
                     backend=backend, checkpoint_dir=ckpt, **opt)
    saved = sorted(p.name for p in ckpt.glob("*")) if r == 0 else None
    on = {str(p.device) for p in st.leaves(resumed.sdf)}
    w.check(resumed.resumed_from == steps - 1 and resumed.steps_run == 1
            and np.allclose(resumed.losses, res.losses[-1:], rtol=1e-6)
            and (saved is None or not any(".tmp" in n for n in saved))
            and on == {str(mesh.device)},
            f"{what} fit(mesh=) resumed from rank 0's checkpoint of step {resumed.resumed_from}: "
            f"last loss {resumed.losses} against {res.losses[-1:]}; files {saved}; the restored "
            f"leaves on {on}")
    w.timed(f"{tag}fit_{steps}_steps_ms",
            lambda: st.fit(fit_start, fit_target, steps=steps, view=fit_view, mesh=mesh,
                           backend=backend, **opt),
            lambda: st.fit(fit_start, fit_target, steps=steps, view=fit_view, backend=backend,
                           **opt))

    # -- resumable tiles over the mesh, then resumed on rank 0 alone.
    tiles_dir = tmp / f"{tag}tiles"
    rows = size["tile_rows"]
    tiles, stats = w.count(f"{tag}tiles", lambda: par.render_tiles_resumable(
        hero, W, H, tiles_dir, tile_rows=rows, view=eye, mesh=mesh, backend=backend))
    with torch.no_grad():
        frame = st.RayMarcher(W, H, hero, view=eye, backend=backend).render().cpu().numpy()
    n_tiles = -(-H // rows)
    w.check(np.array_equal(tiles, frame) and stats == {"resumed": 0, "rendered": n_tiles,
                                                        "tiles": n_tiles},
            f"{what} {n_tiles} tiles of {rows} rows over the mesh equal the frame bit for bit "
            f"({stats})")
    mesh.barrier()
    if r == 0:
        for t in (1, n_tiles - 1):
            (tiles_dir / f"tile_{t:05d}.npy").unlink()
        again, stats = par.render_tiles_resumable(hero, W, H, tiles_dir, tile_rows=rows, view=eye,
                                                  backend=backend)
        w.check(np.array_equal(again, frame) and stats["rendered"] == 2
                and stats["resumed"] == n_tiles - 2,
                f"{what} the frame resumed on one rank after two tiles were deleted: bit for bit "
                f"({stats})")
    mesh.barrier()


def same_brick(bricks, whole) -> bool:
    """Whether this rank's ``VoxelBricks`` are its layers of ``whole``, bit for bit."""
    z0, k = bricks.z0, bricks.values.shape[2]
    return (torch.equal(bricks.values, whole.values[:, :, z0:z0 + k])
            and torch.equal(bricks.colors, whole.colors[:, :, z0:z0 + k]))


def same_mesh(got, want) -> bool:
    """Vertices, triangles, normals and colours array-equal, and not empty."""
    return len(got.vertices) > 0 and all(
        np.array_equal(getattr(got, f), getattr(want, f))
        for f in ("vertices", "triangles", "normals", "colors"))


def grid_checks(w: Worker) -> None:
    """voxelize_sharded and create_mesh_sharded (the plain torch path on the
    device: neither has a kernel)."""

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch import scenes

    mesh, one, size = w.mesh, w.one, w.size
    what = f"[{mesh.size} ranks]"
    hero = scenes.sphere_repeat_scene()

    nx, ny, nz = size["vox"]
    lo, hi = ((-2.0,) * 3, (2.0,) * 3) if size["times"] else ((-1.0,) * 3, (1.0,) * 3)
    bricks = par.voxelize_sharded(mesh, hero, lo, hi, nx, ny, nz)
    with torch.no_grad():
        whole = st.voxelize(hero, lo, hi, nx, ny, nz)
    w.check(same_brick(bricks, whole),
            f"{what} voxelize_sharded {nx}x{ny}x{nz}: this rank's brick (layers {bricks.z0} + "
            f"{bricks.values.shape[2]}) equals voxelize's bit for bit")
    if not size["times"]:
        gathered = bricks.gather()
        w.check(torch.equal(gathered.values, whole.values)
                and torch.equal(gathered.colors, whole.colors),
                f"{what} VoxelBricks.gather() equals voxelize bit for bit")
        w.keep("vox_values", gathered.values)
    del bricks, whole

    n = size["grid"]
    scene = hero if size["times"] else st.sphere(0.5, color=(0.8, 0.4, 0.2))
    bricks = w.count("voxelize_sharded", lambda: par.voxelize_sharded(mesh, scene, lo, hi, n, n, n))
    with torch.no_grad():
        whole = st.voxelize(scene, lo, hi, n, n, n)
    w.check(same_brick(bricks, whole), f"{what} voxelize_sharded {n}^3 brick equals voxelize's")
    ref = whole.to_mesh()
    cases = [("bricks", bricks, {})]
    if not size["times"]:
        cases += [("whole Voxels", whole, {}), ("bricks step=2", bricks, {"step": 2}),
                  ("bricks iso 0.25", bricks, {"iso_value": 0.25})]
    for name, vox, kw in cases:
        got = par.create_mesh_sharded(mesh, vox, **kw)
        want = ref if not kw else whole.to_mesh(**kw)
        w.check(same_mesh(got, want), f"{what} create_mesh_sharded on {n}^3 {name} {kw or ''}: "
                      f"{len(got.vertices)} vertices, {len(got.triangles) // 3} triangles; "
                      f"vertices, triangles, normals and colours array-equal to to_mesh()'s "
                      f"({len(want.vertices)})")
        if name == "bricks":
            w.report["mesh_vertices"] = len(got.vertices)
            for f in ("vertices", "triangles", "normals", "colors"):
                w.keep(f"mesh_{f}", getattr(got, f))
    if not size["times"]:
        # A brick thinner than the step: the halo comes from several bricks.
        thin = st.voxelize(scene, lo, hi, 10, 10, 7)
        got, want = par.create_mesh_sharded(mesh, thin, step=3), thin.to_mesh(step=3)
        w.check(len(got.vertices) > 0 and np.array_equal(got.vertices, want.vertices)
                and np.array_equal(got.triangles, want.triangles),
                f"{what} create_mesh_sharded, 7 layers at step 3 (bricks of "
                f"{-(-7 // mesh.size)} layers): {len(got.vertices)} vertices as to_mesh()")
    w.timed(f"voxelize_sharded_{n}^3_ms",
            lambda: par.voxelize_sharded(mesh, scene, lo, hi, n, n, n),
            lambda: par.voxelize_sharded(one, scene, lo, hi, n, n, n))
    one_bricks = par.voxelize_sharded(one, scene, lo, hi, n, n, n)
    w.timed(f"create_mesh_sharded_{n}^3_ms", lambda: par.create_mesh_sharded(mesh, bricks),
            lambda: par.create_mesh_sharded(one, one_bricks))


def full_size_extras(w: Worker) -> None:
    """dryrun_multichip's last section at full size: a 4K depth frame."""

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch import scenes

    mesh = w.mesh
    W, H = w.size["depth4k"]
    hero = scenes.sphere_repeat_scene()
    depth = w.count("render_sharded_depth_4k",
                    lambda: par.render_sharded(mesh, hero, W, H, depth_only=True))
    with torch.no_grad():
        ref = st.render_depth(hero, W, H)
    w.check(depth.shape == (H, W) and torch.equal(depth, ref),
            f"[{mesh.size} ranks] render_sharded depth {W}x{H} equals render_depth bit for bit")
    w.timed(f"render_sharded_depth_{W}x{H}_ms",
            lambda: par.render_sharded(mesh, hero, W, H, depth_only=True),
            lambda: par.render_sharded(w.one, hero, W, H, depth_only=True))
    del depth, ref
    if w.size.get("rgb4k"):
        rgb = w.count("render_sharded_rgb_4k", lambda: par.render_sharded(mesh, hero, W, H))
        with torch.no_grad():
            ref = st.render(hero, W, H)
        w.check(rgb.shape == (H, W, 3) and torch.equal(rgb, ref),
                f"[{mesh.size} ranks] render_sharded RGB {W}x{H} equals render bit for bit")
        w.timed(f"render_sharded_rgb_{W}x{H}_ms", lambda: par.render_sharded(mesh, hero, W, H),
                lambda: par.render_sharded(w.one, hero, W, H))
        del rgb, ref
    # The collectives alone, at the sizes the 1080p paths hand them: a frame's
    # band (RGB) in the all-gather, a step's gradients and loss in the all-reduce.
    fw, fh = w.size["width"], w.size["height"]
    band = torch.zeros((-(-fh // mesh.size), fw, 3), device=mesh.device)
    grads = torch.zeros(sum(p.numel() for p in st.leaves(hero)) + 1, device=mesh.device)
    w.timed(f"all_gather_band_{fw}x{fh}_ms", lambda: mesh.all_gather(band))
    w.timed("all_reduce_gradients_ms", lambda: mesh.all_reduce_sum(grads))
    w.timed(f"all_gather_band_{fw}x{fh}_ms_of_{COLLECTIVE_REPEAT}",
            lambda: mesh.all_gather(band), repeat=COLLECTIVE_REPEAT)
    w.timed(f"all_reduce_gradients_ms_of_{COLLECTIVE_REPEAT}",
            lambda: mesh.all_reduce_sum(grads), repeat=COLLECTIVE_REPEAT)
    if w.size.get("big_grid"):
        big_grid_checks(w, w.size["big_grid"])


def big_grid_checks(w: Worker, n: int) -> None:
    """voxelize_sharded and create_mesh_sharded of SphereRepeat at n^3
    against the grid and the mesh of one device, with times."""

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch import scenes

    mesh, one = w.mesh, w.one
    hero = scenes.sphere_repeat_scene()
    lo, hi = (-2.0,) * 3, (2.0,) * 3
    bricks = w.count(f"voxelize_sharded_{n}", lambda: par.voxelize_sharded(mesh, hero, lo, hi,
                                                                            n, n, n))
    with torch.no_grad():
        whole = st.voxelize(hero, lo, hi, n, n, n)
    w.check(same_brick(bricks, whole),
            f"[{mesh.size} ranks] voxelize_sharded {n}^3: this rank's brick (layers {bricks.z0} + "
            f"{bricks.values.shape[2]}) equals voxelize's bit for bit")
    got, want = par.create_mesh_sharded(mesh, bricks), whole.to_mesh()
    del whole
    w.check(same_mesh(got, want),
            f"[{mesh.size} ranks] create_mesh_sharded on {n}^3 bricks: {len(got.vertices)} "
            f"vertices; vertices, triangles, normals and colours array-equal to to_mesh()'s "
            f"({len(want.vertices)})")
    w.report[f"mesh_vertices_{n}"] = len(got.vertices)
    del got, want
    w.timed(f"voxelize_sharded_{n}^3_ms", lambda: par.voxelize_sharded(mesh, hero, lo, hi, n, n, n),
            lambda: par.voxelize_sharded(one, hero, lo, hi, n, n, n))
    one_bricks = par.voxelize_sharded(one, hero, lo, hi, n, n, n) if mesh.rank == 0 else None
    w.timed(f"create_mesh_sharded_{n}^3_ms", lambda: par.create_mesh_sharded(mesh, bricks),
            lambda: par.create_mesh_sharded(one, one_bricks))


def run_worker(a, host_calls=None) -> int:
    """One rank: join the group, run every check, report. ``a`` holds the
    parsed arguments of :func:`parser`. ``host_calls``: the launch counts of
    stand-ins that a caller put in place of the kernel launches, which run
    the kernel route on CPU tensors too (``Worker.launches``)."""
    sys.path.insert(0, REPO)

    import sdfkit_tpu_torch as st
    from sdfkit_tpu_torch import parallel as par
    from sdfkit_tpu_torch.parallel import distributed

    if a.device == "cpu":
        st.set_default_device("cpu")
        torch.set_num_threads(1)
    elif not torch.cuda.is_available():
        raise RuntimeError("--device cuda and torch.cuda.is_available() is false")
    par.initialize(a.init, backend=a.backend, world_size=a.ranks, rank=a.rank,
                   timeout=datetime.timedelta(seconds=a.timeout))
    mesh = par.make_mesh()
    if mesh.size != a.ranks or mesh.rank != a.rank:
        raise RuntimeError(f"rank {mesh.rank} of {mesh.size}, expected {a.rank} of {a.ranks}")
    if a.device == "cuda" and mesh.device.type != "cuda":
        raise RuntimeError(f"rank {mesh.rank} is on {mesh.device}, not a card")
    w = Worker(mesh, distributed.single(mesh.device), SIZES[a.size], host_calls)
    t0 = time.perf_counter()
    # One directory for every rank's checkpoints and tiles: they share a disk.
    shared = pathlib.Path(a.scratch)
    backends = ["kernel", "torch"] if host_calls is not None else \
        (["kernel"] if a.device == "cuda" else ["torch"])
    for backend in backends:
        run_checks(w, backend, "k_" if backend == "kernel" else "", shared)
    grid_checks(w)
    if "depth4k" in w.size:
        full_size_extras(w)
    w.report["seconds"] = time.perf_counter() - t0
    from sdfkit_tpu_torch.render.cuda import build

    w.report["nvcc_builds"] = build.BUILDS
    if a.out:
        out = pathlib.Path(a.out)
        np.savez(out / f"rank{mesh.rank}.npz", **w.outputs)
        (out / f"rank{mesh.rank}.json").write_text(json.dumps(w.report))
    print("REPORT " + json.dumps(w.report), flush=True)
    failed = [what for ok, what in w.report["checks"] if not ok]
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 1 if failed else 0


def launch(ranks: int = 2, device: str = "cuda", size: str = "small", backend: str | None = None,
           out=None, timeout: float = 600.0, echo: bool = False, worker=None,
           worker_args=()) -> list[dict]:
    """Spawn ``ranks`` workers and wait for them; returns each rank's report
    (checks, times, launches). Raises unless every worker exited 0 with
    every check passed. ``device``: "cuda" (every rank on the card) or
    "cpu". ``echo`` prints rank 0's output once the ranks are done.
    ``worker``: the program each rank runs (this file by default), given
    the arguments of :func:`parser` and then ``worker_args``."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the ranks run on the card and torch.cuda.is_available() is false; "
                           "pass device='cpu' to run them on the CPU")
    if backend == "nccl":
        sys.path.insert(0, REPO)
        from sdfkit_tpu_torch.parallel.distributed import require_cards

        require_cards(ranks)
    with tempfile.TemporaryDirectory() as d:
        scratch = os.path.join(d, "shared")
        os.makedirs(scratch)
        program = os.path.abspath(__file__) if worker is None else os.fspath(worker)
        cmd = [sys.executable, program, "--worker", "--init",
               f"file://{d}/rendezvous", "--ranks", str(ranks), "--device", device, "--size",
               size, "--scratch", scratch, "--timeout", str(int(timeout))]
        if backend:
            cmd += ["--backend", backend]
        if out:
            cmd += ["--out", os.fspath(out)]
        cmd += list(worker_args)
        logs = [open(os.path.join(d, f"rank{r}.log"), "w+") for r in range(ranks)]
        # Every rank is local: rank r takes card r under NCCL.
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=logs[r],
                                  stderr=subprocess.STDOUT, text=True, cwd=REPO,
                                  env={**os.environ, "LOCAL_RANK": str(r),
                                       "LOCAL_WORLD_SIZE": str(ranks)})
                 for r in range(ranks)]
        # A rank that fails leaves the others waiting in a collective: stop
        # them all at the first failure, or at the deadline.
        deadline = time.monotonic() + timeout
        try:
            while time.monotonic() < deadline:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                    break
                time.sleep(0.1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for f in logs:
            f.seek(0)
            texts.append(f.read())
            f.close()
    if echo:
        print(texts[0], end="", flush=True)
    reports, failed = [], []
    for r, (p, text) in enumerate(zip(procs, texts)):
        lines = [ln for ln in text.splitlines() if ln.startswith("REPORT ")]
        if p.returncode != 0 or not lines:
            failed.append(f"rank {r} of {ranks} failed (rc={p.returncode}):\n{text[-4000:]}")
        else:
            reports.append(json.loads(lines[-1][len("REPORT "):]))
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--init")
    ap.add_argument("--rank", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cuda")
    ap.add_argument("--size", choices=tuple(SIZES), default="small")
    ap.add_argument("--backend", choices=("gloo", "nccl"))
    ap.add_argument("--out")
    ap.add_argument("--scratch")
    ap.add_argument("--timeout", type=float, default=600.0)
    return ap


def main() -> int:
    a = parser().parse_args()
    if a.worker:
        return run_worker(a)
    reports = launch(a.ranks, a.device, a.size, a.backend, a.out, a.timeout, echo=True)
    checks = sum(len(r["checks"]) for r in reports)
    print(f"torch.distributed exercise passed: {a.ranks} ranks ({reports[0]['backend']}), "
          f"{checks} checks")
    return 0


if __name__ == "__main__":
    sys.exit(main())
