"""Restartable rendering: a frame in row tiles, each persisted as it finishes.

Counterpart of ``sdfkit_tpu/parallel/elastic.py`` for one device. The frame
renders in row tiles, every finished tile is written atomically (temporary
file, then rename: one ``.npy`` per tile plus a manifest), and a re-run of
the same job resumes from the surviving tiles, bit-identical to an
uninterrupted run because each tile is rendered by the same per-tile program
either way. The JAX package can also shard a tile's rows over a device mesh;
that waits for the port's multi-device path, and ``mesh=`` is refused until
then.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os

import numpy as np
import torch

from sdfkit_tpu_torch.render.raymarch import RenderConfig, render_rays, resolve_backend
from sdfkit_tpu_torch.sdf.compile import compile_scene
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device
from sdfkit_tpu_torch.utils.camera import camera_rays, default_view, inv_view_proj
from sdfkit_tpu_torch.utils.v3 import V3


def _scene_fingerprint(sdf: SdfExpr) -> str:
    """Stable hash of the scene's structure and parameter values: the hash of
    its compiled program, then every leaf's dtype, shape and bytes. The port's
    own: a manifest written by the JAX package (which hashes its pytree
    structure) never matches, so tiles do not cross between the packages."""
    h = hashlib.sha256()
    h.update(compile_scene(sdf).hash.encode())
    for leaf in leaves(sdf):
        a = leaf.detach().cpu().numpy()
        h.update(str(a.dtype).encode())
        h.update(str(a.shape).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def render_tiles_resumable(
    sdf: SdfExpr,
    width: int,
    height: int,
    checkpoint_dir,
    tile_rows: int = 128,
    view=None,
    mesh=None,
    progress=None,
    backend: str = "auto",
    **cfg_kwargs,
):
    """Render an (H, W, 3) image in resumable row tiles.

    Every completed tile is written to ``checkpoint_dir`` before the next
    starts; rerunning after a crash skips finished tiles. Returns
    ``(image, stats)``: the image as a numpy array and the counts of resumed
    and rendered tiles. ``progress(done, total)`` is called after every tile.

    ``backend``: 'kernel' renders each tile with the CUDA image kernel (rays
    made in the kernel from the tile's pixel offset, ``render_rows_kernel``),
    'torch' with the plain path on slices of the full frame's rays, 'auto'
    the kernel for a scene on CUDA. The backend is part of the manifest: the
    two paths round differently, so a resume must use the backend that made
    the existing tiles. So are the scene (``_scene_fingerprint``), the view
    and the render settings: a directory that holds another job's tiles is
    refused.
    """
    if mesh is not None:
        raise NotImplementedError(
            "render_tiles_resumable(mesh=...) shards a tile over devices; the port's "
            "multi-device path is not there yet"
        )
    cfg = RenderConfig(width=int(width), height=int(height), **cfg_kwargs)
    tile_rows = int(tile_rows)
    if tile_rows < 1:
        raise ValueError(f"tile_rows must be at least 1, got {tile_rows}")
    device = scene_device(sdf)
    if view is None:
        view = default_view(device)
    else:
        view = torch.as_tensor(view, dtype=torch.float32, device=device)
    backend = resolve_backend(backend, sdf)
    os.makedirs(checkpoint_dir, exist_ok=True)

    manifest_path = os.path.join(checkpoint_dir, "manifest.json")
    manifest = {
        "width": cfg.width,
        "height": cfg.height,
        "tile_rows": tile_rows,
        "view": view.detach().cpu().numpy().tolist(),
        "scene": _scene_fingerprint(sdf),
        "config": repr(cfg),
        "backend": backend,
    }
    if os.path.exists(manifest_path):
        with open(manifest_path) as f:
            existing = json.load(f)
        if existing != manifest:
            raise ValueError(
                f"checkpoint_dir {checkpoint_dir} holds tiles of a different "
                f"job (manifest mismatch); use a fresh directory"
            )
    else:
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, manifest_path)

    # A crash between np.save(tmp) and os.replace leaves an orphan: sweep
    # them at the start so they never pile up across crashes.
    for leftover in glob.glob(os.path.join(checkpoint_dir, "*.tmp.npy")):
        with contextlib.suppress(OSError):
            os.unlink(leftover)

    render_tile = _make_tile_renderer(sdf, view, cfg, backend)

    n_tiles = -(-cfg.height // tile_rows)
    tiles = []
    resumed = rendered = 0
    for t in range(n_tiles):
        path = os.path.join(checkpoint_dir, f"tile_{t:05d}.npy")
        if os.path.exists(path):
            tiles.append(np.load(path))
            resumed += 1
        else:
            r0 = t * tile_rows
            r1 = min(cfg.height, r0 + tile_rows)
            tile = render_tile(r0, r1 - r0).cpu().numpy()
            tmp = path + ".tmp.npy"
            np.save(tmp, tile)
            os.replace(tmp, path)  # atomic: a crash never leaves half a tile
            tiles.append(tile)
            rendered += 1
        if progress is not None:
            progress(t + 1, n_tiles)

    image = np.concatenate(tiles, axis=0)
    return image, {"resumed": resumed, "rendered": rendered, "tiles": n_tiles}


def _make_tile_renderer(sdf: SdfExpr, view: torch.Tensor, cfg: RenderConfig, backend: str):
    """The per-tile render ``render_tile(row0, n_rows) -> (n_rows, W, 3)``.

    The kernel path needs no ray arrays: the kernel makes a tile's rays from
    its flat pixel offset, with the view scalars prepared once. The plain
    path makes the full frame's rays once and slices each tile's rows, so
    tile boundaries never change the ray math."""
    if backend == "kernel":
        from sdfkit_tpu_torch.render.cuda.raymarch_kernel import render_rows_kernel

        with torch.no_grad():
            ivp, cam = inv_view_proj(view, cfg.width, cfg.height, cfg.vfov_degrees,
                                     cfg.near, cfg.far)

        def render_tile(r0, n_rows):
            with torch.no_grad():
                return render_rows_kernel(sdf, ivp, cam, r0 * cfg.width, cfg, n_rows)

        return render_tile

    with torch.no_grad():
        ro, rd = camera_rays(cfg.width, cfg.height, view, cfg.vfov_degrees, cfg.near, cfg.far)

    def render_tile(r0, n_rows):
        def rows(v: V3) -> V3:
            return V3(*(c[r0:r0 + n_rows] for c in (v.x, v.y, v.z)))

        with torch.no_grad():
            return render_rays(sdf, rows(ro), rows(rd), cfg)

    return render_tile
