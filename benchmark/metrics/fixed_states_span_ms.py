"""ms an iteration in the span ``fixed_states`` (``loss.fixed_state_log_ratios``,
the fixed lower states' forward, inside ``gradient``), by the port's CUDA
events inside the window's blocks: the median over blocks
(:mod:`benchmark.harness.spans`)."""

from benchmark.harness import spans


def read(run):
    return spans.read_span(run, "fixed_states")
