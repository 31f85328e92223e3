"""What every loop (``loops/<loop>.py``) shares: the outcome it returns,
the measured window under the profiler, a seeded sample of what the window
produced, and the device's clock and peak.

A loop builds the cell's inputs from the seed, builds the scene through
the port's DSL, warms the kernels it uses, measures its window, reads the
trace where asked, and checks what the window produced against the
reference, in that order. The reference runs after the window has closed
and the device's peak memory has been read, and after the program's state
is freed.
"""

from __future__ import annotations

import dataclasses
import os
import random
import tempfile

import torch

from benchmark.harness import trace

WINDOW = "bench.window"  # the span around the measured window
FORWARD, BACKWARD = "_RenderImage", "_RenderImageBackward"  # the render's autograd node
TRACE_SECONDS = 2.0  # a traced window's length at most


@dataclasses.dataclass
class Outcome:
    attempted: int
    failed: int
    end_to_end: dict  # metric name -> value
    ctx: dict  # what the per-layer readers read
    checks: list  # check.Check
    setup: dict  # seconds from the process's start to each step of set-up
    memory_peak_bytes: int
    builds: int  # nvcc runs in this process


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0


def free(device) -> None:
    """Hand the freed program state back before the reference runs."""
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def on_card(device) -> bool:
    return torch.device(device).type == "cuda"


def window_seconds(seconds: float, traced: bool) -> float:
    return min(seconds, TRACE_SECONDS) if traced else seconds


class Profiled:
    """The window under ``torch.profiler`` where the run is traced, inside
    a span named ``WINDOW``; its Chrome trace reduced once it has closed."""

    def __init__(self, on: bool, device, warm=None):
        self.on, self.device, self.warm = on, torch.device(device), warm

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile, record_function

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self.prof = profile(activities=acts)
            self.prof.__enter__()
            if self.warm is not None:  # the tracer's own first-use cost, outside the window
                self.warm()
                sync(self.device)
            self.span = record_function(WINDOW)
            self.span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            sync(self.device)
            self.span.__exit__(*exc)
            self.prof.__exit__(*exc)
        return False

    def reduce(self) -> trace.Summary | None:
        if not self.on:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return trace.summarize(trace.load(path), WINDOW, (FORWARD, BACKWARD))
        finally:
            os.unlink(path)


class DeviceClock:
    """The device's busy time over the whole window, where ``on``: a trace
    of the device's activity alone (CUPTI through ``torch.profiler``, no
    host spans), reduced from the profiler's own events once the window has
    closed, with nothing written to disk. The window's last synchronise
    comes before ``__exit__``, so the trace holds all of its work."""

    def __init__(self, on: bool):
        self.on = on

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self.prof.__exit__(*exc)
        return False

    def busy_s(self) -> float | None:
        """Seconds in which an operation (a kernel, copy or fill) ran on the
        device; None where off or where the trace holds no device activity."""
        if not self.on:
            return None
        from torch._C._autograd import DeviceType

        busy = trace.union_length((e.start_ns(), e.start_ns() + e.duration_ns())
                                  for e in self.prof.profiler.kineto_results.events()
                                  if e.device_type() == DeviceType.CUDA) * 1e-9
        return busy if busy > 0 else None


class Reservoir:
    """A sample of ``size`` items of a stream of unknown length, drawn from
    a seeded generator."""

    def __init__(self, size: int, rng: random.Random):
        self.size, self.rng, self.items, self.seen = size, rng, [], 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.size:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.size:
                self.items[j] = item


def mean_needs(readings: list[dict]) -> dict:
    return {k: sum(r[k] for r in readings) / len(readings) for k in readings[0]}
