"""Host milliseconds a frame spends on the scene's program and flat
parameters (``_program_and_params``: the ``compile_scene`` lookup, its walk
of the tree's structure, and ``flat_params``' concatenation of every leaf),
from the program's ``sdf.render.params`` spans under each of the traced
window's ``sdf.frame`` spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "frames":
        return None
    return program_spans.per_request_ms(ctx, "sdf.render.params")
