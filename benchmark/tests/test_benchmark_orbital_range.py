"""The reader of ``orbital_range_passes`` and the two cells that came with it.

On synthetic records: 2 where every local energy counted two harmonic-range
launches of the orbital head's kernel (2Q+1 = 66), 1 where it counted one,
the median over the window's blocks, and ``None`` on records without the
count (a program before the count, or the CPU, where no kernel runs).  Then
the entries: the metric in all eight cells, ``n6q15.infer_l2`` and
``n14q65.train_l2`` loaded through :func:`cells.load_cell` with the metrics
of their kind, the new configuration nothing reduced, and each new cell's
count the one a recount gives.
"""

import json
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import cells
from benchmark.work import count, counter

LENGTH = 10
NEW_CELLS = ("n6q15.infer_l2", "n14q65.train_l2")
TRAINING_ONLY = ("grad_span_ms", "kfac_update_span_ms", "orbital_factors_span_ms", "kfac_gram_share")


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
    return cells.metric_reader("orbital_range_passes")(context)


@pytest.mark.parametrize("records,want", [
    ([record({"orbitals.fused": 10, "orbitals.range": 20})] * 3, 2.0),  # 2Q+1 = 66
    ([record({"orbitals.fused": 10, "orbitals.range": 10, "sweep.replayed": 10})] * 3, 1.0),
    # The median over the window's blocks.
    ([record({"orbitals.range": 20}), record({"orbitals.range": 20}), record({"orbitals.range": 10})],
     2.0),
    # A window block without a launch among blocks with.
    ([record({"orbitals.range": 10}), record({"sweep.replayed": 10}), record({"sweep.replayed": 10})],
     0.0),
])
def test_the_passes_a_local_energy(monkeypatch, records, want):
    assert reading(monkeypatch, records) == want


@pytest.mark.parametrize("records", [
    [record(None), record(None)],  # a program without block counts
    [record({"orbitals.fused": 10, "sweep.replayed": 10})] * 2,  # the parent: no orbitals.range
    [record({"orbitals.range": 10}, profiled=True), record({"orbitals.range": 1}, length=1),
     record({"orbitals.range": 10}, period=None)],  # no window block
    [record({"orbitals.range": 0}, energies=None)],  # no local energy
])
def test_nothing_to_read_reads_none(monkeypatch, records):
    assert reading(monkeypatch, records) is None


def test_a_cpu_run_reads_none():
    """The CPU takes the plain version: no kernel launched, nothing is counted."""
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n6q15.infer_l2")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 23, 1.0, torch.device("cpu"), batch=4)
    records = [r for r in tracing.blocks() if r.index > before]
    assert records and not any("orbitals.range" in r.counts for r in records)
    assert cells.metric_reader("orbital_range_passes")(SimpleNamespace(cfg=result.cfg)) is None


def test_the_entries():
    bench = cells.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}["orbital_range_passes"]
    assert (entry["source"], entry["moves"], entry["better"]) == ("program_counter", "iters_per_s", "lower")
    assert entry["layer"] == "local energy: networks.fwdlap orbital head and determinants"
    assert entry["workloads"] == [w["name"] for w in bench["workloads"]] and len(entry["workloads"]) == 8
    assert [w["name"] for w in bench["workloads"]][-2:] == list(NEW_CELLS)
    config = {c["name"]: c for c in bench["configs"]}["psiformer_n14_q65"]
    assert config["reduced"] == [] and len(config["source"]) <= 200
    for name in NEW_CELLS:
        cell = cells.load_cell(name, bench)
        assert cell.chips == 1
        assert (cells.ROOT / cell.job["checkpoint"]).is_file()
        reported = [m["name"] for m in cell.per_layer]
        assert "orbital_range_passes" in reported and "orbital_fused_share" in reported
        training = cell.job["config"]["optim"]["optimizer"] != "none"
        assert all((metric in reported) == training for metric in TRAINING_ONLY), (name, reported)
        assert cell.job["config"]["system"]["compute_l2"] is True


def test_the_new_configuration():
    cell = cells.load_cell("n14q65.train_l2")
    system, net = cell.config["system"], cell.config["network"]
    assert system["nspins"] == [14, 0] and system["flux"] == 5 * (14 - 1)
    assert net["orbital"] == "full" and net["psiformer"] == {
        "num_heads": 4, "heads_dim": 64, "num_layers": 2, "determinants": 1}
    assert cell.config["batch_size"] == 3360 and cell.config["mcmc"]["steps"] == 10
    job = cell.job
    assert (job["recorded_steps"], job["checked_blocks"], job["reference_rows"]) == (3, 0, 168)
    kfac = job["config"]["optim"]["kfac"]
    assert (kfac["lr"]["rate"], kfac["lr"]["decay"], kfac["lr"]["delay"], kfac["damping"],
            kfac["curvature_ema"], kfac["norm_constraint"]) == (0.05, 1.0, 2000.0, 1e-3, 0.95, 1e-3)
    inference = cells.load_cell("n6q15.infer_l2").job
    assert (inference["recorded_steps"], inference["checked_blocks"], inference["reference_rows"]) == (1, 2, 168)
    assert inference["config"]["optim"]["optimizer"] == "none"


@pytest.mark.parametrize("name", NEW_CELLS)
def test_the_new_cells_counts_are_recounted(name):
    """Each new cell's stored count is the one a recount gives (16 and 32
    walkers carried to 3360, checked against the count at 48)."""
    cell = cells.load_cell(name)
    stored = json.loads(cells.work_path(cell.config_name, cell.job_name).read_text())
    fresh = counter.summary(count.per_iteration(cell))
    assert fresh["flops"] == stored["flops"] and fresh["bytes"] == stored["bytes"]
    assert stored["batch"] == 3360 and stored["operations_ms"] > 0
