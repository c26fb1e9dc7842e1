"""ms an iteration in the span ``update`` (``optimizers.kfac.kfac_update`` in the
KFAC step), by the port's CUDA events inside the window's blocks: the median
over blocks (:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "update")
