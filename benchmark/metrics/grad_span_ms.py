"""ms an iteration in the span ``gradient`` (``loss.gradient_and_capture``: the
float32 forward, the statistics and penalties, the fixed-state ratios, both
backward passes), by the port's CUDA events inside the window's blocks: the
median over blocks (:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "gradient")
