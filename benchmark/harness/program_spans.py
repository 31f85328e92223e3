"""What the program's own spans and counters say about a run, for the
per-layer readers (``metrics/``).

The port keeps its spans in memory (``sdfkit_tpu_torch.utils.spans``): on
while a profiler records, so in a traced run the warm call before the window
and the window itself. The window's requests are the last ``ctx["count"]``
top-level spans of the loop's kind (``sdf.fit.step`` a step, ``sdf.frame``
a frame); the reference runs none of the port's code after them. A program
without those spans or counters, or whose ring dropped a record of the
window, gives nothing to read: None, never an error.
"""

from __future__ import annotations

import importlib

TOPS = {"fit": "sdf.fit.step", "frames": "sdf.frame"}  # a loop's request


def _spans():
    try:
        return importlib.import_module("sdfkit_tpu_torch.utils.spans")
    except ImportError:
        return None


def window_roots(spans, top: str, count: int, recs: list) -> list | None:
    """The ids of the last ``count`` top-level spans named ``top`` among
    ``recs``, or None where there are fewer, or where the ring dropped a
    record that ended after the first of them began."""
    roots = [r for r in recs if r.name == top and r.root == r.id]
    if count <= 0 or len(roots) < count:
        return None
    window = roots[-count:]
    if spans.DROPPED and recs[0].t1_ns >= window[0].t0_ns:
        return None
    return [r.id for r in window]


def per_request_ms(ctx: dict, name: str) -> float | None:
    """Milliseconds of the spans named ``name`` a request of the window,
    summed over each request's spans on every thread; None where the
    program gives nothing to read."""
    spans = _spans()
    top = TOPS.get(ctx.get("loop"))
    if spans is None or top is None:
        return None
    recs = spans.records()
    roots = window_roots(spans, top, int(ctx.get("count") or 0), recs)
    if roots is None:
        return None
    s = spans.summary(roots, recs).get(name)
    return None if s is None else s["total_ms"] / len(roots)


def counter(module: str, name: str) -> float | None:
    """The program's counter ``module.name``; None where it has none."""
    try:
        value = getattr(importlib.import_module(module), name)
    except (ImportError, AttributeError):
        return None
    return float(value)
