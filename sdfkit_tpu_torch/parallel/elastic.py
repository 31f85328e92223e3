"""Restartable rendering: a frame in row tiles, each persisted as it finishes.

Counterpart of ``sdfkit_tpu/parallel/elastic.py``. The frame renders in row
tiles, every finished tile is written atomically (temporary file, then
rename: one ``.npy`` per tile plus a manifest), and a re-run of the same job
resumes from the surviving tiles, bit-identical to an uninterrupted run
because each tile is rendered by the same per-row program either way. With a
``mesh`` each tile's rows are split in bands over the ranks
(``train.render_rows_sharded``); rank 0 alone writes, and the mesh is not
part of the manifest, so a frame started on four ranks resumes on one.
"""

from __future__ import annotations

import contextlib
import glob
import hashlib
import json
import os

import numpy as np
import torch

from sdfkit_tpu_torch.parallel.distributed import Mesh, single
from sdfkit_tpu_torch.parallel.train import render_rows_sharded, row_renderer
from sdfkit_tpu_torch.render.raymarch import RenderConfig, resolve_backend
from sdfkit_tpu_torch.sdf.compile import compile_scene
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device
from sdfkit_tpu_torch.utils.camera import default_view


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

    ``mesh``: a ``parallel.Mesh`` to split each tile's rows over its ranks
    (every rank calls this with the same arguments and gets the image). The
    checkpoint directory is one that every rank sees; rank 0 alone writes
    the manifest and the tiles, and the ranks wait for it after each tile.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a sdfkit_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
    mesh = single(scene_device(sdf)) if mesh is None else mesh
    writer = mesh.rank == 0
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
    if writer:
        os.makedirs(checkpoint_dir, exist_ok=True)
    mesh.barrier()

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
    elif writer:
        tmp = manifest_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, manifest_path)

    n_tiles = -(-cfg.height // tile_rows)
    paths = [os.path.join(checkpoint_dir, f"tile_{t:05d}.npy") for t in range(n_tiles)]
    if writer:
        # A crash between np.save(tmp) and os.replace leaves an orphan: sweep
        # them at the start so they never pile up across crashes.
        for leftover in glob.glob(os.path.join(checkpoint_dir, "*.tmp.npy")):
            with contextlib.suppress(OSError):
                os.unlink(leftover)
    # Rank 0 says which tiles exist, so that every rank renders the same ones.
    done = torch.tensor([writer and os.path.exists(p) for p in paths], dtype=torch.int32,
                        device=mesh.device)
    done = mesh.all_reduce_sum(done).tolist()

    render = row_renderer(sdf, view, cfg, backend)
    tiles = []
    resumed = rendered = 0
    for t, path in enumerate(paths):
        if done[t]:
            tiles.append(np.load(path))
            resumed += 1
        else:
            r0 = t * tile_rows
            with torch.no_grad():
                tile = render_rows_sharded(mesh, render, r0, min(cfg.height, r0 + tile_rows) - r0)
            tile = tile.cpu().numpy()
            if writer:
                tmp = path + ".tmp.npy"
                np.save(tmp, tile)
                os.replace(tmp, path)  # atomic: a crash never leaves half a tile
            mesh.barrier()
            tiles.append(tile)
            rendered += 1
        if progress is not None:
            progress(t + 1, n_tiles)

    image = np.concatenate(tiles, axis=0)
    return image, {"resumed": resumed, "rendered": rendered, "tiles": n_tiles}
