"""Differentiable SDF fitting: optimize shape, position and colour parameters
so a render matches a target image.

Counterpart of ``sdfkit_tpu/fit.py``. Every ``SdfExpr`` is an ``nn.Module``
whose leaves are parameters, and the renderer is differentiable on both
backends: ``backend="kernel"`` takes each step through the hand-written CUDA
forward and backward kernels (``render/cuda/raymarch_kernel.py``),
``backend="torch"`` through autograd of the plain path, and ``"auto"`` picks
the kernels for a scene on CUDA.

Checkpoint and resume: the step, the leaves and the optimizer state are saved
with ``torch.save`` every ``checkpoint_every`` steps, and ``fit`` resumes
from the latest step found in ``checkpoint_dir``.

Every step runs over the ranks of a ``parallel.Mesh`` (``mesh=``; without
one, the mesh of this process alone): each rank renders its row band, one
all-reduce sums the gradients and the loss, and the clipping and Adam run on
the summed gradient, so every rank takes the same step (the JAX package's
``_fit_step_sharded`` and ``_fit_step_sharded_fused``).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import pathlib
import re
from typing import Callable

import numpy as np
import torch

from sdfkit_tpu_torch.render.raymarch import RayMarcher, resolve_backend
from sdfkit_tpu_torch.sdf.expr import SdfExpr, leaves, scene_device
from sdfkit_tpu_torch.utils.spans import span

CHECKPOINTS_KEPT = 2


@dataclasses.dataclass(frozen=True)
class FitResult:
    sdf: SdfExpr
    losses: list[float]
    steps_run: int
    resumed_from: int | None


def clip_by_global_norm_(params, max_norm: float) -> None:
    """Scale the gradients in place so their global norm is at most
    ``max_norm``, as ``optax.clip_by_global_norm`` does: untouched below the
    bound, ``g / norm * max_norm`` above it
    (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 to the norm instead)."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(norm < max_norm, g, g / norm * max_norm))


def _checkpoints(directory: pathlib.Path) -> list[tuple[int, pathlib.Path]]:
    found = []
    for path in directory.glob("step_*.pt"):
        m = re.fullmatch(r"step_(\d+)\.pt", path.name)
        if m:
            found.append((int(m.group(1)), path))
    return sorted(found)


def _save(directory: pathlib.Path, step: int, params, optimizer) -> None:
    """Write the checkpoint of ``step`` under a temporary name, rename it
    into place, and drop all but the newest ``CHECKPOINTS_KEPT``."""
    state = {
        "step": step,
        "leaves": [p.detach().cpu() for p in params],
        "optimizer": optimizer.state_dict(),
    }
    path = directory / f"step_{step:08d}.pt"
    tmp = directory / f"{path.name}.{os.getpid()}.tmp"
    torch.save(state, tmp)
    os.replace(tmp, path)
    for _, old in _checkpoints(directory)[:-CHECKPOINTS_KEPT]:
        old.unlink()


def _restore(path: pathlib.Path, params, optimizer) -> int:
    state = torch.load(path, map_location="cpu", weights_only=True)
    if len(state["leaves"]) != len(params):
        raise ValueError(
            f"{path} holds {len(state['leaves'])} leaves, the scene has {len(params)}"
        )
    with torch.no_grad():
        for p, saved in zip(params, state["leaves"]):
            if saved.shape != p.shape:
                raise ValueError(
                    f"{path}: a leaf of shape {tuple(saved.shape)} for a parameter "
                    f"of shape {tuple(p.shape)}"
                )
            p.copy_(saved)
    optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def fit(
    sdf: SdfExpr,
    target,
    steps: int = 100,
    view=None,
    optimizer: Callable[[list], torch.optim.Optimizer] | None = None,
    learning_rate: float = 1e-2,
    checkpoint_dir=None,
    checkpoint_every: int = 50,
    progress: Callable[[int, float], None] | None = None,
    backend: str = "auto",
    mesh=None,
    **cfg_kwargs,
) -> FitResult:
    """Fit ``sdf``'s parameters so its render matches ``target`` (H, W, 3).

    Returns a FitResult with the fitted scene (a copy: ``sdf`` itself keeps
    its values) and the loss of every step. If ``checkpoint_dir`` is given,
    training state is checkpointed there and a later call with the same
    directory resumes from the latest saved step.

    ``backend``: 'kernel' differentiates through the CUDA forward and
    backward kernels (a scene on CUDA only), 'torch' through autograd of the
    plain path, 'auto' picks the kernels for a scene on CUDA. The frame is
    rendered on the scene's device; ``target`` and ``view`` are moved there.

    ``optimizer``: a factory from the list of parameters to a
    ``torch.optim.Optimizer``. The default is global-norm clipping at 1.0,
    then Adam: sphere-trace image losses have heavy-tailed gradients (a ray
    that grazes a silhouette accumulates depth and its parameter gradient
    explodes), so unclipped Adam overshoots. A caller's optimizer runs
    unclipped.

    ``mesh``: a ``parallel.Mesh`` to split every step's frame in row bands
    over its ranks; every rank calls ``fit`` with the same arguments and gets
    the same result. Rank 0 alone writes checkpoints; a resume restores on
    every rank from ``checkpoint_dir``, which every rank sees.
    """
    with span("sdf.fit.setup"):
        from sdfkit_tpu_torch.parallel.distributed import Mesh, single
        from sdfkit_tpu_torch.parallel.train import band_loss_and_grads, row_renderer

        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a sdfkit_tpu_torch.parallel.Mesh, got {type(mesh).__name__}")
        backend = resolve_backend(backend, sdf)  # refuse a bad backend before the scene is copied
        sdf = copy.deepcopy(sdf)
        device = scene_device(sdf)
        if not isinstance(target, torch.Tensor):
            target = torch.from_numpy(np.array(target, dtype=np.float32))  # a copy it may own
        target = target.to(device=device, dtype=torch.float32)
        if target.ndim != 3 or target.shape[2] != 3:
            raise ValueError(f"the target must be an (H, W, 3) image, got {tuple(target.shape)}")
        height, width = target.shape[:2]
        if view is not None:
            view = torch.as_tensor(view, dtype=torch.float32, device=device)
        marcher = RayMarcher(width, height, sdf, view=view, backend=backend, **cfg_kwargs)
        mesh = single(device) if mesh is None else mesh
        render = row_renderer(sdf, marcher.view, marcher.config, backend)

        params = leaves(sdf)
        clip = optimizer is None
        opt = torch.optim.Adam(params, lr=learning_rate) if clip else optimizer(params)

        start_step, resumed_from = 0, None
        directory = None
        if checkpoint_dir is not None:
            directory = pathlib.Path(os.path.abspath(os.fspath(checkpoint_dir)))
            directory.mkdir(parents=True, exist_ok=True)
            found = _checkpoints(directory)
            if found:
                start_step = resumed_from = _restore(found[-1][1], params, opt)

    losses: list[float] = []
    for step in range(start_step, steps):
        with span("sdf.fit.step", top=True):
            # Every leaf's gradient, also of those a caller's optimizer leaves out.
            loss = band_loss_and_grads(mesh, render, params, target)
            with span("sdf.fit.optimizer"):
                if clip:
                    clip_by_global_norm_(params, 1.0)
                opt.step()
            with span("sdf.fit.sync"):
                loss = loss.item()  # waits for the step, as the reference's loop does
            losses.append(loss)
            if progress is not None:
                with span("sdf.fit.progress"):
                    progress(step, loss)
            if directory is not None and ((step + 1) % checkpoint_every == 0 or step + 1 == steps):
                with span("sdf.fit.checkpoint"):
                    if mesh.rank == 0:
                        _save(directory, step + 1, params, opt)
                    mesh.barrier()
    return FitResult(sdf=sdf, losses=losses, steps_run=steps - start_step,
                     resumed_from=resumed_from)


__all__ = ["FitResult", "clip_by_global_norm_", "fit"]
