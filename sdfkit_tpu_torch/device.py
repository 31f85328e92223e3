"""The package's default device: the card, unless the caller asks for the CPU.

Scene factories, ``look_at`` / ``default_view`` and everything built on them
(``render``, ``RayMarcher``, ``fit``) make their tensors on
:func:`default_device`: ``cuda`` when ``torch.cuda.is_available()``. The CPU
is never picked silently. Ask for it with ``device="cpu"`` on a factory,
with :func:`set_default_device`, or for a block of code with
:func:`use_device`; with no card and no such request, building a scene
raises and says so.
"""

from __future__ import annotations

import contextlib

import torch

_requested: torch.device | None = None


def set_default_device(device) -> None:
    """Make every later scene and view on ``device`` ("cpu", "cuda",
    "cuda:1", a ``torch.device``); ``None`` returns to the card."""
    global _requested
    _requested = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The requested device, else the current CUDA device; raises when
    there is neither."""
    if _requested is not None:
        return _requested
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise RuntimeError(
        "sdfkit_tpu_torch runs on a CUDA device by default and "
        "torch.cuda.is_available() is false. To run on the CPU, ask for it: "
        "sdfkit_tpu_torch.set_default_device('cpu'), or device='cpu' on the "
        "scene factory and on look_at."
    )


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device``, or the default when it is None."""
    return default_device() if device is None else torch.device(device)


@contextlib.contextmanager
def use_device(device):
    """Scenes and views built inside the block go to ``device``."""
    global _requested
    before = _requested
    set_default_device(device)
    try:
        yield
    finally:
        _requested = before
