"""The orbital head's metrics (``orbital_jet_span_ms``, ``orbital_factors_span_ms``,
``orbital_jet_bound_pct``) and the cells that added them.

The work of the orbital jet by hand; the three readers read ``None`` where the
program has no such span (an inference block has no ``orbital_factors``, the
parent of the change that added the spans has neither) and where it has no
tracing at all; a CPU run of ``n10q27_l4k16.train_lean`` at a few walkers reads
all three; the new cells' counts are the ones a recount gives.
"""

import json
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import cells, spans
from benchmark.work import count, counter, kernels, orbitals

NEW = {"orbital_jet_span_ms": "orbitals", "orbital_factors_span_ms": "orbital_factors",
       "orbital_jet_bound_pct": "orbitals"}
NEW_CELLS = ("n6q15.train_lean", "n10q27_l4k16.train_lean")
# The spans' metrics whose lists the new cells joined, read from the same blocks.
LISTED = ("sweep_span_ms", "local_energy_span_ms", "grad_span_ms", "kfac_update_span_ms")


def test_orbital_jet_work_by_hand():
    # B=2, N=3, 2Q=2 (3 harmonics), D=4, K=2, c=7 tangents with e=1 extra: 10 planes.
    nbytes, operations = orbitals.orbital_jet_work(2, 3, 2, 4, 2, 7, 1)
    features = 3 * 3 * 2  # (2Q + 1) N K
    head = 4 * 10 * 2 * 3 * 4 * features
    envelope = 8 * 2 * 3 * 3 * 2 * 3 * (1 + 7 + 3 + 4 + 3)
    determinants = 2 * 2 * (8 * 27 // 3 + 8 * 9 * 9 * 3)
    assert operations == head + envelope + determinants
    assert nbytes == 10 * 2 * 3 * 4 * 4 + 10 * 2 * 2 * 9 * 8


def test_the_new_cells_least_time():
    """At N=10, 2Q=27, 16 determinants the projection leads: 3.70 TFLOP at
    three TF32 products' rate, 22.4 ms; at one determinant a sixteenth."""
    c, e = kernels.jet_channels(10, False)
    least = orbitals.orbital_jet_least(3360, 10, 27, 256, 16, c, e)
    assert least.bound == "operations" and least.seconds == pytest.approx(22.6e-3, rel=0.01)
    one = orbitals.orbital_jet_least(3360, 10, 27, 256, 1, c, e)
    assert one.seconds == pytest.approx(least.seconds / 16, rel=0.02)


def record(period, length=10, profiled=False, **ms):
    parents = {"orbitals": "local_energy", "orbital_factors": "update"}
    return SimpleNamespace(length=length, profiled=profiled, period_ms=period, spans={
        name: SimpleNamespace(ms=value, calls=length, parent=parents.get(name))
        for name, value in ms.items()})


def context():
    cfg = SimpleNamespace(
        batch_size=3360, optim=SimpleNamespace(block_size=10),
        system=SimpleNamespace(nspins=(10, 0), flux=27, compute_l2=False, l2_penalty=0.0),
        network=SimpleNamespace(psiformer=SimpleNamespace(num_heads=4, heads_dim=64, determinants=16)))
    return SimpleNamespace(cfg=cfg)


def reading(monkeypatch, records):
    from deephall_tpu_torch import tracing

    monkeypatch.setattr(tracing, "blocks", lambda: records)
    return {name: cells.metric_reader(name)(context()) for name in NEW}


def test_the_readers(monkeypatch):
    got = reading(monkeypatch, [record(4000.0, sweep=900.0, local_energy=2300.0, orbitals=1500.0,
                                       update=900.0, orbital_factors=500.0)] * 3)
    assert got["orbital_jet_span_ms"] == 150.0 and got["orbital_factors_span_ms"] == 50.0
    least = orbitals.orbital_jet_least(3360, 10, 27, 256, 16, 21, 1)
    assert got["orbital_jet_bound_pct"] == pytest.approx(100 * least.seconds * 1e3 / 150.0)


@pytest.mark.parametrize("spans_there, none", [
    ({"sweep": 300.0, "local_energy": 500.0}, set(NEW)),  # the parent: no orbital span
    ({"sweep": 300.0, "local_energy": 500.0, "orbitals": 200.0}, {"orbital_factors_span_ms"}),  # inference
])
def test_no_span_no_reading(monkeypatch, spans_there, none):
    got = reading(monkeypatch, [record(1000.0, **spans_there)] * 2)
    assert {name for name, value in got.items() if value is None} == none


def test_a_program_without_tracing_reads_none(monkeypatch):
    import deephall_tpu_torch

    monkeypatch.delattr(deephall_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "deephall_tpu_torch.tracing", None)  # the import fails
    for name in NEW:
        assert cells.metric_reader(name)(context()) is None


def test_the_entries():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    assert [w["name"] for w in bench["workloads"][-2:]] == list(NEW_CELLS)
    for name in NEW:
        m = entries[name]
        assert m["moves"] == "iters_per_s" and m["source"] == "program_span"
        for workload in m["workloads"]:
            assert name in [x["name"] for x in cells.load_cell(workload, bench).per_layer]
    assert "n10q27.infer_lean" not in entries["orbital_factors_span_ms"]["workloads"]
    config = cells.load_cell("n10q27_l4k16.train_lean", bench).config
    psiformer = config["network"]["psiformer"]
    assert (psiformer["num_layers"], psiformer["determinants"], psiformer["num_heads"],
            psiformer["heads_dim"]) == (4, 16, 4, 64)


def test_a_cpu_run_of_the_new_cell_reads_its_metrics():
    """The fresh 4-layer, 16-determinant state at 8 walkers, its window's
    blocks read as the traced run reads them: all three new metrics."""
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n10q27_l4k16.train_lean")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 19, 2.0, torch.device("cpu"), batch=8)
    records = [r for r in spans.qualifying(tracing.blocks(), result.cfg.optim.block_size)
               if r.index > before]
    assert records  # the warm-up block at least
    context = SimpleNamespace(cfg=result.cfg)
    got = {name: cells.metric_reader(name)(context) for name in (*NEW, *LISTED)}
    assert all(value is not None and value > 0 for value in got.values()), got
    for record in records:
        assert record.spans["orbitals"].parent == "local_energy"
        assert record.spans["orbital_factors"].parent == "update"
        assert record.spans["orbitals"].ms <= record.spans["local_energy"].ms


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_new_cells_counts_are_recounted(name):
    """Each new cell's stored count is the one a recount gives (16 and 32
    walkers carried to 3360, checked against the count at 48)."""
    cell = cells.load_cell(name)
    stored = json.loads(cells.work_path(cell.config_name, cell.job_name).read_text())
    fresh = counter.summary(count.per_iteration(cell))
    assert fresh["flops"] == stored["flops"] and fresh["bytes"] == stored["bytes"]
    assert stored["batch"] == 3360 and stored["operations_ms"] > 0
