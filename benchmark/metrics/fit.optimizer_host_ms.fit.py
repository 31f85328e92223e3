"""Host milliseconds a fit step spends in the optimizer (the clip where it
is ``fit``'s default, and ``opt.step()``), from the program's
``sdf.fit.optimizer`` spans under each of the traced window's
``sdf.fit.step`` spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "fit":
        return None
    return program_spans.per_request_ms(ctx, "sdf.fit.optimizer")
