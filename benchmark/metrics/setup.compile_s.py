"""Seconds the run's process spent in the scene compiler: ``compile_scene``'s
misses, each tracing a scene's structure into its program and emitting its
C++ and adjoint (the program's ``compile.TRACE_SECONDS``). It all falls in
set-up: the window and the reference trace nothing."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter("sdfkit_tpu_torch.sdf.compile", "TRACE_SECONDS")
