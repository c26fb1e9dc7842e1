"""The reader of ``sweep_graph_share``: the share of the sweep's calls that
replayed a CUDA graph, from the counts in the port's block records.

On synthetic records: 100 where every call replayed, 50 where half did, the
median over the window's blocks, and ``None`` on records without the counts
(a program without ``mcmc.GraphedSweep``).  Then a short run of a cell on the
CPU, where every sweep runs eagerly: 0.
"""

from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import cells

LENGTH = 10


def record(counts=None, length=LENGTH, profiled=False, period=1000.0):
    fields = dict(length=length, profiled=profiled, period_ms=period, spans={})
    if counts is not None:
        fields["counts"] = counts
    return SimpleNamespace(**fields)


def reading(monkeypatch, records):
    from deephall_tpu_torch import tracing

    monkeypatch.setattr(tracing, "blocks", lambda: records)
    context = SimpleNamespace(cfg=SimpleNamespace(optim=SimpleNamespace(block_size=LENGTH)))
    return cells.metric_reader("sweep_graph_share")(context)


def test_the_metric_finds_its_reader_in_every_cell():
    bench = cells.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}["sweep_graph_share"]
    assert (entry["source"], entry["moves"], entry["unit"], entry["better"]) == (
        "program_span", "iters_per_s", "%", "higher")
    assert entry["layer"] == "sweep: mcmc.make_mcmc_step"
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]]
    for workload in entry["workloads"]:
        assert "sweep_graph_share" in [m["name"] for m in cells.load_cell(workload, bench).per_layer]


@pytest.mark.parametrize("records,want", [
    ([record({"sweep.replayed": 10})] * 3, 100.0),
    ([record({"sweep.replayed": 5, "sweep.eager": 5})] * 3, 50.0),
    ([record({"sweep.replayed": 5, "sweep.captured": 1, "sweep.eager": 4})], 50.0),
    # The warm-up block (a capture and nine replays) and two of the window's.
    ([record({"sweep.captured": 1, "sweep.replayed": 9}), record({"sweep.replayed": 10}),
      record({"sweep.replayed": 10})], 100.0),
])
def test_the_median_share_of_replays(monkeypatch, records, want):
    assert reading(monkeypatch, records) == want


@pytest.mark.parametrize("records", [
    [record(None), record(None)],  # the parent: no counts in its records
    [record({}), record({"other": 3})],  # no sweep counted
    [record({"sweep.replayed": 10}, profiled=True), record({"sweep.replayed": 1}, length=1),
     record({"sweep.replayed": 10}, period=None)],  # no window block
])
def test_nothing_to_read_reads_none(monkeypatch, records):
    assert reading(monkeypatch, records) is None


def test_a_cpu_run_reads_every_sweep_eager():
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n10q27.infer_lean")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 11, 1.0, torch.device("cpu"), batch=4)
    records = [r for r in tracing.blocks() if r.index > before]
    assert records and all(r.counts == {"sweep.eager": r.length} for r in records)
    context = SimpleNamespace(cfg=result.cfg)
    assert cells.metric_reader("sweep_graph_share")(context) == 0.0
