"""Host milliseconds a fit step spends on the gradients outside the render
(the leaves' zeroing, their gather into one buffer with the loss, the
all-reduce and the split back into every leaf's ``.grad``), from the
program's ``sdf.fit.grads`` spans under each of the traced window's
``sdf.fit.step`` spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "fit":
        return None
    return program_spans.per_request_ms(ctx, "sdf.fit.grads")
