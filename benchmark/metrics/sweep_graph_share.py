"""The share of the sweep's calls that replayed a CUDA graph (``mcmc.GraphedSweep``),
by the port's counts in its block records: ``100 * replayed / calls`` a block,
the median over the window's blocks (:mod:`benchmark.harness.spans`).  A
program whose records hold no such counts reads ``None``."""

import statistics

from benchmark.harness import spans

HOWS = ("replayed", "captured", "eager")


def share(records) -> float | None:
    values = []
    for r in records:
        counts = getattr(r, "counts", None) or {}
        calls = sum(counts.get(f"sweep.{how}", 0) for how in HOWS)
        if calls:
            values.append(100.0 * counts.get("sweep.replayed", 0) / calls)
    return statistics.median(values) if values else None


def read(run):
    return share(spans.window_blocks(run))
