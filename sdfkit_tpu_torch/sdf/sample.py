"""Batched point sampling.

Counterpart of ``sdfkit_tpu/sdf/sample.py``. The reference chunks an
arbitrary point array into batches so the working set stays bounded whatever
the point count; the JAX package maps the scene over statically shaped
batches of 2048 with a zero-padded remainder, because ``jit`` wants one shape.
Eager torch has no shape to keep: the batches are slices, the last one short,
and the default batch is large (2**20 points, about 100 MB of temporaries a
scene node), because on a card a batch costs its kernel launches whatever its
size. ``batch_size`` is a memory cap, nothing else.
"""

from __future__ import annotations

import torch

from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device

DEFAULT_BATCH_SIZE = 1 << 20


def sample(sdf: SdfExpr, points, batch_size: int = DEFAULT_BATCH_SIZE) -> torch.Tensor:
    """Evaluate ``sdf`` at ``points``, at most ``batch_size`` at a time.

    ``points``: (N, 3); an array that is not a tensor is put on the scene's
    device. Returns (N, 4) on the points' device: RGB in [..., :3], signed
    distance in [..., 3]. A tensor on another device than the scene's
    parameters raises."""
    if not isinstance(points, torch.Tensor):
        points = torch.as_tensor(points, dtype=torch.float32, device=scene_device(sdf))
    points = points.to(torch.float32)
    if points.ndim != 2 or points.shape[-1] != 3:
        raise ValueError(f"points must be (N, 3), got {tuple(points.shape)}")
    if leaves(sdf) and points.device != scene_device(sdf):
        raise ValueError(
            f"the points are on {points.device} but the scene is on {scene_device(sdf)}"
        )
    batch_size = int(batch_size)
    if batch_size < 1:
        raise ValueError(f"batch_size must be at least 1, got {batch_size}")
    n = points.shape[0]
    if n <= batch_size:
        return sdf(points) if n else points.new_zeros((0, 4))
    return torch.cat([sdf(points[start:start + batch_size]) for start in range(0, n, batch_size)])
