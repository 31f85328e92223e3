"""What a ``torch.profiler`` trace of the window says, reduced from its
Chrome trace: the device's busy time, its device time attributed to the
host-side spans that launched it, and where it idled.

A kernel is attributed to a span by its launch: the CUDA runtime or driver
call that carries the kernel's correlation id lies, on the launching
thread, inside the span's interval (or, where the trace has no such call,
the span whose "External id" the kernel carries). So a span stands for
every kernel launched inside it, whatever the kernels are called: the
render's autograd node (``_RenderImage``, ``_RenderImageBackward``) keeps
its device time when a kernel inside it is split or renamed.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SPAN_CATS = ("cpu_op", "user_annotation", "python_function")
LISTED = 10  # entries of each breakdown list


@dataclasses.dataclass
class Summary:
    window_s: float  # the window span's length
    busy_s: float  # the union of device activity inside it
    device_s: float  # the sum of device activity inside it
    by_span: dict  # span name -> device seconds launched inside a span of that name
    device_ops: list  # [[name, seconds]] the longest device operations, summed by name
    idle_gaps: list  # [[what the host was doing, seconds]] idle time, summed by that


def _events(trace) -> list:
    return trace["traceEvents"] if isinstance(trace, dict) else trace


def load(path) -> list:
    with open(path) as f:
        return _events(json.load(f))


class _Intervals:
    """Disjoint intervals of one span name on one thread, for the question
    "is one open at time t"."""

    def __init__(self, spans):
        spans = sorted((e["ts"], e["ts"] + e.get("dur", 0)) for e in spans)
        self.starts = [a for a, _ in spans]
        self.ends = [b for _, b in spans]

    def open_at(self, t: float) -> bool:
        i = bisect.bisect_right(self.starts, t) - 1
        return i >= 0 and self.ends[i] >= t


def _innermost(spans, times) -> list:
    """For each of the increasing ``times``, the innermost of the nested
    ``spans`` open then (None where none is), by one sweep."""
    spans = sorted(spans, key=lambda e: (e["ts"], -e.get("dur", 0)))
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i]["ts"] <= t:
            stack.append(spans[i])
            i += 1
        while stack and stack[-1]["ts"] + stack[-1].get("dur", 0) < t:
            stack.pop()
        out.append(stack[-1] if stack else None)
    return out


def _union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def union_length(spans) -> float:
    """The length of the union of (start, end) spans, in their unit."""
    return sum(b - a for a, b in _union(spans))


def summarize(events, window: str, spans_of_interest) -> Summary | None:
    """Reduce the events inside the user span named ``window`` (the last
    one, where there are several). ``spans_of_interest``: the span names
    whose device time ``by_span`` gives. None where the trace has no such
    window."""
    windows = [e for e in events if e.get("ph") == "X" and e.get("name") == window
               and e.get("cat") in SPAN_CATS]
    if not windows:
        return None
    win = windows[-1]
    w0, w1 = win["ts"], win["ts"] + win["dur"]
    wanted = tuple(spans_of_interest)
    interest = collections.defaultdict(list)  # (name, pid, tid) -> spans
    host_spans = []
    launches, by_external = {}, {}
    device = []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat in SPAN_CATS:
            where = (e.get("pid"), e.get("tid"))
            if e["name"] in wanted:
                interest[(e["name"], *where)].append(e)
            if where == (win.get("pid"), win.get("tid")) and w0 <= e["ts"] <= w1 and e is not win:
                host_spans.append(e)
            ext = e.get("args", {}).get("External id")
            if ext is not None:
                by_external.setdefault(ext, e)
        elif cat in LAUNCH_CATS:
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = e
        elif cat in DEVICE_CATS and w0 <= e["ts"] and e["ts"] + e.get("dur", 0) <= w1:
            device.append(e)
    interest = {k: _Intervals(v) for k, v in interest.items()}

    def launch_point(kernel):
        """(pid, tid, time) of the host call that launched ``kernel``."""
        args = kernel.get("args", {})
        launch = launches.get(args.get("correlation"))
        if launch is None:
            launch = by_external.get(args.get("External id"))
        return None if launch is None else (launch.get("pid"), launch.get("tid"), launch["ts"])

    by_span = {name: 0.0 for name in wanted}
    by_name = collections.Counter()
    for k in device:
        dur = k.get("dur", 0) * 1e-6
        by_name[k["name"].removeprefix("void ").split("(")[0][:120]] += dur
        point = launch_point(k)
        if point is None:
            continue
        for name in wanted:
            spans = interest.get((name, point[0], point[1]))
            if spans is not None and spans.open_at(point[2]):
                by_span[name] += dur
    busy = _union((k["ts"], k["ts"] + k.get("dur", 0)) for k in device)

    idle = []
    edge = w0
    for a, b in busy + [[w1, w1]]:
        if a > edge:
            idle.append((edge, a))
        edge = max(edge, b)
    gaps = collections.Counter()
    for (a, b), span in zip(idle, _innermost(host_spans, [(a + b) / 2 for a, b in idle])):
        gaps["(no span)" if span is None else span["name"]] += (b - a) * 1e-6
    return Summary(
        window_s=(w1 - w0) * 1e-6,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=sum(by_name.values()),
        by_span=by_span,
        device_ops=[[n, s] for n, s in by_name.most_common(LISTED)],
        idle_gaps=[[n, s] for n, s in gaps.most_common(LISTED)],
    )
