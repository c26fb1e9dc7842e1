"""The reader of ``kfac_gram_share``: the share of KFAC's Kronecker factors
that the Gram-product kernel formed, from the counts in the port's block
records.

On synthetic records: 100 where every factor counted ``kfac.gram``, the share
of a block where some did, the median over the window's blocks, and ``None``
on records without ``kfac.factors`` (a program without the count, or a cell
that runs no update).  Then a short run of the inference cell on the CPU: no
update, so ``None``.
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
    return cells.metric_reader("kfac_gram_share")(context)


def test_the_metric_finds_its_reader_in_the_training_cells():
    bench = cells.load_benchmark()
    entry = {m["name"]: m for m in bench["per_layer"]}["kfac_gram_share"]
    assert (entry["source"], entry["moves"], entry["unit"], entry["better"]) == (
        "program_counter", "iters_per_s", "%", "higher")
    assert entry["layer"] == "optimizer: optimizers.kfac.kfac_update"
    assert entry["workloads"] == ["n6q15.train_l2", "n6q15.sector6_train", "n10q27.train_lean",
                                  "n6q15.train_lean", "n10q27_l4k16.train_lean"]
    for workload in entry["workloads"]:
        assert "kfac_gram_share" in [m["name"] for m in cells.load_cell(workload, bench).per_layer]
    assert "kfac_gram_share" not in [
        m["name"] for m in cells.load_cell("n10q27.infer_lean", bench).per_layer]


@pytest.mark.parametrize("records,want", [
    # 10 iterations of 30 factors, every one by the kernel.
    ([record({"kfac.factors": 300, "kfac.gram": 300, "sweep.replayed": 10})] * 3, 100.0),
    ([record({"kfac.factors": 300, "kfac.gram": 75})] * 3, 25.0),
    # The median over the window's blocks.
    ([record({"kfac.factors": 300, "kfac.gram": 300}), record({"kfac.factors": 300, "kfac.gram": 300}),
      record({"kfac.factors": 300, "kfac.gram": 150})], 100.0),
    # A block whose factors took no kernel (the CPU's plain version) among blocks that did.
    ([record({"kfac.factors": 300}), record({"kfac.factors": 300}),
      record({"kfac.factors": 300, "kfac.gram": 300})], 0.0),
])
def test_the_median_share_of_factors_by_the_kernel(monkeypatch, records, want):
    assert reading(monkeypatch, records) == want


@pytest.mark.parametrize("records", [
    [record(None), record(None)],  # a program without block counts
    [record({"sweep.replayed": 10}), record({})],  # the parent: no kfac.factors
    [record({"orbitals.fused": 10, "sweep.replayed": 10})],  # no update (an inference cell)
    [record({"kfac.factors": 300, "kfac.gram": 300}, profiled=True),
     record({"kfac.factors": 30, "kfac.gram": 30}, length=1),
     record({"kfac.factors": 300, "kfac.gram": 300}, period=None)],  # no window block
])
def test_nothing_to_read_reads_none(monkeypatch, records):
    assert reading(monkeypatch, records) is None


def test_a_cpu_run_of_the_inference_cell_reads_none():
    """No update runs, so no factor is counted."""
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n10q27.infer_lean")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 17, 1.0, torch.device("cpu"), batch=4)
    records = [r for r in tracing.blocks() if r.index > before]
    assert records and not any("kfac.factors" in r.counts for r in records)
    context = SimpleNamespace(cfg=result.cfg)
    assert cells.metric_reader("kfac_gram_share")(context) is None
