"""Seconds from building the scene to its first frame on the host: the
port's DSL, ``compile_scene``, loading the kernel library and the first
launch, synchronised. A fit's first frame is its first step, whose loss
``fit`` fetches: it also loads the backward's library and runs it once."""


def read(ctx):
    return ctx.get("first_frame_s")
