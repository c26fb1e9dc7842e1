"""ms an iteration of the loop outside every layer span: a block's period (its
start to the next block's, by the port's CUDA events) less its top-level
spans, the median over the window's blocks (:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_rest(run)
