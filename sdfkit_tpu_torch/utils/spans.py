"""Host spans at the port's layer boundaries, kept in memory.

``with span("sdf.fit.grads"):`` marks a stretch of host work with a name.
Spans are off by default: ``span`` then reads two flags and returns one
shared no-op context manager, allocating nothing and calling no C++. They
are on while a ``torch.profiler`` records (``torch.autograd.profiler``'s
own flag) or after ``enable()``. An open span then

* opens a ``torch.profiler.record_function`` range of its name where a
  profiler records, so the span lies on the profiler's timeline, on the same
  clock as the device's events (without a profiler such a range records
  nothing and costs about 9 us, so it is not opened);
* keeps, when it closes, one record (read back as a ``Record``) in a ring
  of ``RING`` records in memory, timed with ``time.perf_counter_ns``.
  ``DROPPED`` counts the records the full ring pushed out since the last
  ``clear()``.

A record's ``parent`` is the span open around it on the same thread. Its
``root`` is the innermost top-level span (``span(name, top=True)``: a fit
step, a frame) open anywhere in the process when it opened, so that work
done for one step on another thread (autograd's device thread runs the
render's backward) carries that step's id.

``summary(roots)`` gives per span name its count, total and self
milliseconds: self is the duration less the part its children on the same
thread cover. Nothing is written to disk: a profiler's Chrome trace holds
the spans.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time

import torch.autograd.profiler as _profiler

RING = 1 << 17  # records kept
DROPPED = 0  # records pushed out of the full ring since the last clear()

Record = collections.namedtuple("Record", "id name root parent thread t0_ns t1_ns")

_enabled = False
_records: collections.deque = collections.deque(maxlen=RING)
_lock = threading.Lock()  # the ring, DROPPED and the open top-level spans
_ids = itertools.count(1)
_tops: list = []  # ids of the top-level spans open in the process, innermost last
_local = threading.local()  # .stack: ids of the spans open on this thread


class _Off:
    """The span while spans are off: one shared instance that does nothing."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "top", "id", "root", "parent", "stack", "range", "t0")

    def __init__(self, name: str, top: bool):
        self.name, self.top = name, top

    def __enter__(self):
        self.id = next(_ids)
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        self.stack = stack
        self.parent = stack[-1] if stack else None
        stack.append(self.id)
        if self.top:
            with _lock:
                _tops.append(self.id)
            self.root = self.id
        else:
            try:
                self.root = _tops[-1]
            except IndexError:
                self.root = None
        self.range = None
        if _profiler._is_profiler_enabled:
            self.range = _profiler.record_function(self.name)
            self.range.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        global DROPPED
        t1 = time.perf_counter_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        self.stack.pop()
        record = (self.id, self.name, self.root, self.parent, threading.get_ident(), self.t0, t1)
        with _lock:
            if self.top:
                _tops.remove(self.id)
            if len(_records) == RING:
                DROPPED += 1
            _records.append(record)
        return False


def span(name: str, top: bool = False):
    """A context manager that marks the host work inside it as ``name``.
    ``top``: a span that stands for one request (a fit step, a frame), the
    ``root`` of every span opened in the process while it is the innermost
    such span open."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, top)


def enable() -> None:
    """Record spans from now on, with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    """Record spans only while a profiler records (the default)."""
    global _enabled
    _enabled = False


def clear() -> None:
    """Empty the ring and zero ``DROPPED``."""
    global DROPPED
    with _lock:
        _records.clear()
        DROPPED = 0


def records() -> list:
    """The ring's records, oldest first (in the order the spans closed)."""
    with _lock:
        return list(map(Record._make, _records))


def summary(roots=None, recs=None) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} over ``recs`` (the ring's
    records where None), or over those whose ``root`` is one of ``roots``."""
    recs = records() if recs is None else list(recs)
    if roots is not None:
        roots = set(roots)
        recs = [r for r in recs if r.root in roots]
    children = collections.defaultdict(list)
    for r in recs:
        if r.parent is not None:
            children[r.parent].append(r)
    out: dict = {}
    for r in recs:
        covered, edge = 0, r.t0_ns
        for c in sorted((c for c in children.get(r.id, ()) if c.thread == r.thread),
                        key=lambda c: c.t0_ns):
            a, b = max(c.t0_ns, edge, r.t0_ns), min(c.t1_ns, r.t1_ns)
            if b > a:
                covered += b - a
            edge = max(edge, b)
        s = out.setdefault(r.name, {"count": 0, "total_ms": 0.0, "self_ms": 0.0})
        s["count"] += 1
        s["total_ms"] += (r.t1_ns - r.t0_ns) * 1e-6
        s["self_ms"] += (r.t1_ns - r.t0_ns - covered) * 1e-6
    return out


__all__ = ["DROPPED", "RING", "Record", "clear", "disable", "enable", "records", "span",
           "summary"]
