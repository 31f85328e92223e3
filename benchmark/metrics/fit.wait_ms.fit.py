"""Milliseconds a fit step waits on the device: the host inside
``loss.item()`` until the step's work is done, from the program's
``sdf.fit.sync`` spans under each of the traced window's ``sdf.fit.step``
spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "fit":
        return None
    return program_spans.per_request_ms(ctx, "sdf.fit.sync")
