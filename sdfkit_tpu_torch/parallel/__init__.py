"""Paths over tiles and, later, devices (``sdfkit_tpu/parallel``). What exists
is the resumable tile renderer on one device."""

from sdfkit_tpu_torch.parallel.elastic import render_tiles_resumable

__all__ = ["render_tiles_resumable"]
