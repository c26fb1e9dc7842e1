"""The orbital head kernel's passes over the tower's jet in one local energy,
by the port's counts in its block records: ``orbitals.range`` (one a
harmonic range that the wrapper ``ops/orbital_head.py:orbital_matrices_jet``
launches the kernel for) over calls of the span ``local_energy`` a block, the
median over the window's blocks (:mod:`benchmark.harness.spans`).  1 where a
column tile holds a pair's harmonics (2Q+1 <= 64), 2 at 2Q+1 = 66.  A program
whose records hold no such count reads ``None``."""

import statistics

from benchmark.harness import spans


def passes(records) -> float | None:
    counted = [r for r in records if "orbitals.range" in (getattr(r, "counts", None) or {})]
    if not counted:
        return None
    values = []
    for r in records:
        energies = r.spans.get("local_energy")
        if energies is not None and energies.calls:
            values.append((getattr(r, "counts", None) or {}).get("orbitals.range", 0) / energies.calls)
    return statistics.median(values) if values else None


def read(run):
    return passes(spans.window_blocks(run))
