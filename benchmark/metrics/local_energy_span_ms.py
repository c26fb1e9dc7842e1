"""ms an iteration in the span ``local_energy`` (the jet local energy inside the
loss), by the port's CUDA events inside the window's blocks: the median over
blocks (:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "local_energy")
