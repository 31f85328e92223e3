"""What ``control.py`` puts in the program's place, as changes to the
float32 reference: the control's precision, a camera nudged by rounding
alone, and a frame altered where it is produced."""

from __future__ import annotations

import torch

from benchmark.reference import render as ref

LOW = torch.bfloat16  # the precision below the float32 every configuration states
ALTERED_ROWS, ALTERED_BY = 64, 0.1
NUDGE = 1e-6  # two float32 ulps of a camera 4-5 units out


def nudged(view: dict, device) -> torch.Tensor:
    """The configuration's camera with its eye moved by ``NUDGE`` along z."""
    eye = [*view["eye"][:2], view["eye"][2] + NUDGE]
    return ref.look_at(eye, view["target"], view["up"], device)


def alter(rgb, rows):
    """Add ``ALTERED_BY`` to the frame's first ``ALTERED_ROWS`` rows."""
    r = torch.arange(rows.start, rows.stop, device=rgb.device)
    return rgb + ALTERED_BY * (r < ALTERED_ROWS).to(rgb.dtype)[:, None, None]
