"""ms an iteration in the span ``orbital_factors`` (KFAC's factor products and
damped solves of the orbital head's blocks, nested in ``update``), by the
port's CUDA events inside the window's blocks: the median over blocks
(:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "orbital_factors")
