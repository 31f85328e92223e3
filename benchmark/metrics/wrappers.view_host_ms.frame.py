"""Host milliseconds a frame spends preparing the view for the kernel
(``view19``: two 4x4 inverses on the card and the 19 scalars'
concatenation), from the program's ``sdf.render.view`` spans under each of
the traced window's ``sdf.frame`` spans."""

from benchmark.harness import program_spans


def read(ctx):
    if ctx["loop"] != "frames":
        return None
    return program_spans.per_request_ms(ctx, "sdf.render.view")
