"""Host milliseconds a frame spends in the render's autograd node's forward
(the library's lookup, the checks, the output's allocation and the launch
on the stream), from the program's ``sdf.render.launch`` spans under each of
the traced window's ``sdf.frame`` spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "frames":
        return None
    return program_spans.per_request_ms(ctx, "sdf.render.launch")
