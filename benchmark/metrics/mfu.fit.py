"""The whole fit step's share of the H100's peak, in percent: the least
time the work of a step needs (the forward's and the pullback's, as
``kernel.fwd_roofline.frame`` and ``kernel.bwd_roofline.fit`` count them),
over the traced window's length a step. It bounds the gain any kernel of
the step can show, and stays when a kernel leaves the path."""

import importlib.util
import pathlib

from benchmark.harness import roofline as r


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}", pathlib.Path(__file__).with_name(name))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


_fwd, _bwd = _load("kernel.fwd_roofline.frame.py"), _load("kernel.bwd_roofline.fit.py")


def read(ctx):
    s = ctx.get("summary")
    if ctx["loop"] != "fit" or s is None or "needs" not in ctx or s.busy_s <= 0:
        return None
    counts, needs = ctx["config"]["counts"], ctx["needs"]
    fwd, bwd = _fwd.need(counts, needs), _bwd.need(counts, needs)
    least = max((fwd[0] + bwd[0]) / r.PEAK_FP32_OPS, (fwd[1] + bwd[1]) / r.PEAK_BYTES)
    return 100.0 * least / (s.window_s / ctx["count"])
