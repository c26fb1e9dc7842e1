"""The port's own layer clock, read for the per-layer metrics ``*_span_ms``
and ``loop_rest_ms``.

``deephall_tpu_torch.tracing.blocks()`` holds a record of each iteration
block the program ran: the device-clock ms of each layer span (CUDA events on
the block's stream), summed over the block, and the block's period, from its
start to the next block's start.  The window's blocks and the warm-up block
are the records that were not profiled, have the job's length and have a
period.  A metric is the median over those blocks of a value per iteration.
A program without the module, or without such a record, reads ``None``.
"""

from __future__ import annotations

import statistics


def window_blocks(run) -> list:
    """The records of the run's un-profiled blocks of the job's length that have a period."""
    try:
        from deephall_tpu_torch import tracing
    except ImportError:
        return []
    return qualifying(tracing.blocks(), run.cfg.optim.block_size)


def qualifying(records, length: int) -> list:
    return [r for r in records
            if not r.profiled and r.length == length and r.period_ms is not None]


def span_ms(records, name: str) -> float | None:
    """ms an iteration in the span ``name``: the median over the records that hold it."""
    values = [r.spans[name].ms / r.length for r in records if name in r.spans]
    return statistics.median(values) if values else None


def rest_ms(records) -> float | None:
    """ms an iteration outside every layer span (the width adaptation, the
    stacking of the statistics, the host read between blocks): the median over
    the records of the period less the top-level spans."""
    values = [(r.period_ms - sum(s.ms for s in r.spans.values() if s.parent is None)) / r.length
              for r in records]
    return statistics.median(values) if values else None


def read_span(run, name: str) -> float | None:
    return span_ms(window_blocks(run), name)


def read_rest(run) -> float | None:
    return rest_ms(window_blocks(run))
