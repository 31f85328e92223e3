"""Seconds the run's process spent loading kernel libraries: ``load_family``'s
misses, nvcc included where the checkout has not built the library, summed
over the threads that load at once (the program's ``build.LOAD_SECONDS``).
It all falls in set-up."""

from benchmark.harness import program_spans


def read(ctx):
    return program_spans.counter("sdfkit_tpu_torch.render.cuda.build", "LOAD_SECONDS")
