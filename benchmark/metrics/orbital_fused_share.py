"""The share of the local energies whose orbital head ran the fused kernel
(``ops/orbital_head.py``), by the port's counts in its block records:
``100 * orbitals.fused / calls of the span local_energy`` a block, the median
over the window's blocks (:mod:`benchmark.harness.spans`).  A program whose
records hold no such count reads ``None``."""

import statistics

from benchmark.harness import spans


def share(records) -> float | None:
    counted = [r for r in records if "orbitals.fused" in (getattr(r, "counts", None) or {})]
    if not counted:
        return None
    values = []
    for r in records:
        energies = r.spans.get("local_energy")
        if energies is not None and energies.calls:
            values.append(100.0 * (getattr(r, "counts", None) or {}).get("orbitals.fused", 0)
                          / energies.calls)
    return statistics.median(values) if values else None


def read(run):
    return share(spans.window_blocks(run))
