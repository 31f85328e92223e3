"""The whole frame's share of the H100's peak, in percent, in the cells
that report ``frame_device_ms``: the least time the work of a frame needs
(the forward's, as ``kernel.fwd_roofline.frame`` counts it), over the
device's busy time a frame in the traced window. It bounds the gain any
kernel of the frame can show there, and stays when a kernel leaves the
path."""

import importlib.util
import pathlib

from benchmark.harness import roofline as r

_spec = importlib.util.spec_from_file_location(
    "benchmark_metric_fwd_need", pathlib.Path(__file__).with_name("kernel.fwd_roofline.frame.py"))
_fwd = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_fwd)


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "frames" or s is None or "needs" not in ctx or s.busy_s <= 0:
        return None
    ops, nbytes = _fwd.need(ctx["config"]["counts"], ctx["needs"])
    return 100.0 * r.least_seconds(ops, nbytes) / (s.busy_s / ctx["count"])
