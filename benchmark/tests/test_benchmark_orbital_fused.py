"""The reader of ``orbital_fused_share``: the share of the local energies
whose orbital head ran the fused kernel, from the counts in the port's block
records.

On synthetic records: 100 where every local energy counted ``orbitals.fused``,
the share of a block where some did, the median over the window's blocks, and
``None`` on records without the count (a program without the kernel).  Then a
short run of a cell on the CPU, where no kernel runs: ``None``.
"""

from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import cells

LENGTH = 10


def record(counts=None, energies=LENGTH, length=LENGTH, profiled=False, period=1000.0):
    spans = {} if energies is None else {
        "local_energy": SimpleNamespace(ms=100.0, calls=energies, parent=None)}
    fields = dict(length=length, profiled=profiled, period_ms=period, spans=spans)
    if counts is not None:
        fields["counts"] = counts
    return SimpleNamespace(**fields)


def reading(monkeypatch, records):
    from deephall_tpu_torch import tracing

    monkeypatch.setattr(tracing, "blocks", lambda: records)
    context = SimpleNamespace(cfg=SimpleNamespace(optim=SimpleNamespace(block_size=LENGTH)))
    return cells.metric_reader("orbital_fused_share")(context)


def test_the_metric_finds_its_reader_in_every_cell():
    bench = cells.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}["orbital_fused_share"]
    assert (entry["source"], entry["moves"], entry["unit"], entry["better"]) == (
        "program_counter", "iters_per_s", "%", "higher")
    assert entry["layer"] == "local energy: networks.fwdlap orbital head and determinants"
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    for workload in entry["workloads"]:
        assert "orbital_fused_share" in [
            m["name"] for m in cells.load_cell(workload, bench).per_layer]


@pytest.mark.parametrize("records,want", [
    ([record({"orbitals.fused": 10, "sweep.replayed": 10})] * 3, 100.0),
    ([record({"orbitals.fused": 5})] * 3, 50.0),
    # A block of the change's window and two more; the median.
    ([record({"orbitals.fused": 10}), record({"orbitals.fused": 10}),
      record({"orbitals.fused": 4})], 100.0),
    # A window block that took no fused head among blocks that did.
    ([record({"orbitals.fused": 10}), record({"sweep.replayed": 10}),
      record({"sweep.replayed": 10})], 0.0),
])
def test_the_median_share_of_fused_local_energies(monkeypatch, records, want):
    assert reading(monkeypatch, records) == want


@pytest.mark.parametrize("records", [
    [record(None), record(None)],  # a program without block counts
    [record({"sweep.replayed": 10}), record({})],  # the parent: no orbitals.fused
    [record({"orbitals.fused": 10}, profiled=True), record({"orbitals.fused": 1}, length=1),
     record({"orbitals.fused": 10}, period=None)],  # no window block
    [record({"orbitals.fused": 0}, energies=None)],  # no local energy
])
def test_nothing_to_read_reads_none(monkeypatch, records):
    assert reading(monkeypatch, records) is None


def test_a_cpu_run_reads_none():
    """The CPU takes the plain version: no kernel ran, nothing is counted."""
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n10q27.infer_lean")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 13, 1.0, torch.device("cpu"), batch=4)
    records = [r for r in tracing.blocks() if r.index > before]
    assert records and not any("orbitals.fused" in r.counts for r in records)
    context = SimpleNamespace(cfg=result.cfg)
    assert cells.metric_reader("orbital_fused_share")(context) is None
