"""A run of one cell, as the result line that ``run.py`` prints last."""

from __future__ import annotations

import subprocess
import sys

import torch

from benchmark.harness import spec

FORBIDDEN = ("jax", "jaxlib", "flax", "sdfkit_tpu")  # top-level names a run may not hold


def forbidden_modules(modules=None) -> list[str]:
    """The modules loaded whose top-level name (the part before the first
    dot, whole) is one of ``FORBIDDEN``."""
    names = sys.modules if modules is None else modules
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def quantity_of(name: str, measured: dict) -> str | None:
    """The loop's quantity that the end-to-end metric ``name`` reports:
    ``name`` itself, or for ``<quantity>.<group>`` the ``<quantity>``, so
    that cells whose runs spread differently take bounds of their own."""
    for quantity in (name, name.split(".")[0]):
        if quantity in measured:
            return quantity
    return None


def run(cell: spec.Cell, seed: int, seconds: float, traced: bool, device, t0: float) -> dict:
    """The cell's run: its result line, with ``checks`` last."""
    outcome = spec.loop(cell.traffic["loop"]).run(cell, seed, seconds, traced, device, t0)
    metrics = {}
    if traced:
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(outcome.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            quantity = quantity_of(m["name"], outcome.end_to_end)
            if quantity is not None:
                metrics[m["name"]] = {"value": outcome.end_to_end[quantity], "unit": m["unit"]}
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": outcome.memory_peak_bytes,
           "power_limit_w": power_limit_w() if on_card else None}
    line = {"correct": all(c.ok for c in outcome.checks), "attempted": outcome.attempted,
            "failed": outcome.failed, "metrics": metrics, "device": dev}
    s = outcome.ctx.get("summary")
    if traced and s is not None:
        dev["busy_s"], dev["window_s"] = s.busy_s, s.window_s
        line["breakdown"] = {"device_ops": s.device_ops, "idle_gaps": s.idle_gaps}
    line["builds"] = outcome.builds
    line["setup"] = outcome.setup
    line["checks"] = {c.name: c.line() for c in outcome.checks}
    return line
