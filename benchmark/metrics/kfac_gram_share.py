"""The share of KFAC's Kronecker factors formed by the Gram-product kernel
(``ops/kfac_gram.py``), by the port's counts in its block records:
``100 * kfac.gram / kfac.factors`` a block, the median over the window's
blocks (:mod:`benchmark.harness.spans`).  A program whose records hold no
``kfac.factors`` count (one without the kernel, or a cell that runs no
update) reads ``None``."""

import statistics

from benchmark.harness import spans


def share(records) -> float | None:
    values = []
    for r in records:
        counts = getattr(r, "counts", None) or {}
        if counts.get("kfac.factors"):
            values.append(100.0 * counts.get("kfac.gram", 0) / counts["kfac.factors"])
    return statistics.median(values) if values else None


def read(run):
    return share(spans.window_blocks(run))
