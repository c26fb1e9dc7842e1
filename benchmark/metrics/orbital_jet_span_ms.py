"""ms an iteration in the span ``orbitals`` (the local energy's orbital head,
envelope contraction and determinants, nested in ``local_energy``), by the
port's CUDA events inside the window's blocks: the median over blocks
(:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "orbitals")
