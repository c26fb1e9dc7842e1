"""The readers of the port's layer spans (``*_span_ms``, ``loop_rest_ms``).

On synthetic block records: profiled blocks, blocks of another length and
blocks without a period are left out, a metric is the median per iteration,
``None`` when no record qualifies, and ``loop_rest_ms`` is the period less the
top-level spans.  On a program without ``deephall_tpu_torch.tracing`` (the
parent of the change that added it) every reader reads ``None``.  Then a short
run of the sector-6 cell on the CPU, read as the traced run reads it.
"""

import statistics
import sys
from types import SimpleNamespace

import pytest
import torch

from benchmark import run
from benchmark.harness import cells, spans

NEW = {"sweep_span_ms": "sweep", "local_energy_span_ms": "local_energy", "grad_span_ms": "gradient",
       "fixed_states_span_ms": "fixed_states", "kfac_update_span_ms": "update"}
LENGTH = 10


def record(period, length=LENGTH, profiled=False, **ms):
    parents = {"fixed_states": "gradient"}
    return SimpleNamespace(length=length, profiled=profiled, period_ms=period, spans={
        name: SimpleNamespace(ms=value, calls=length, parent=parents.get(name))
        for name, value in ms.items()})


RECORDS = [
    record(1000.0, sweep=500.0, local_energy=200.0, gradient=150.0, fixed_states=50.0, update=100.0),
    record(1100.0, sweep=600.0, local_energy=210.0, gradient=160.0, fixed_states=60.0, update=90.0),
    record(1300.0, sweep=700.0, local_energy=220.0, gradient=170.0, fixed_states=70.0, update=80.0),
    record(9000.0, profiled=True, sweep=9000.0),  # the profiled block
    record(100.0, length=1, sweep=90.0),  # a recorded iteration, a block of one
    record(None, sweep=1.0),  # the last block: no next block has started
]


def cfg(length=LENGTH):
    return SimpleNamespace(optim=SimpleNamespace(block_size=length))


def reading(monkeypatch, records, length=LENGTH):
    from deephall_tpu_torch import tracing

    monkeypatch.setattr(tracing, "blocks", lambda: records)
    context = SimpleNamespace(cfg=cfg(length))
    names = [*NEW, "loop_rest_ms"]
    return {name: cells.metric_reader(name)(context) for name in names}


def test_every_new_metric_finds_its_reader():
    bench = cells.load_benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in [*NEW, "loop_rest_ms"]:
        m = entries[name]
        assert (m["source"], m["moves"], m["unit"], m["better"]) == (
            "program_span", "iters_per_s", "ms", "lower")
        assert callable(cells.metric_reader(name))
        for workload in m["workloads"]:
            assert name in [x["name"] for x in cells.load_cell(workload, bench).per_layer]


def test_the_median_per_iteration_of_the_window_blocks(monkeypatch):
    got = reading(monkeypatch, RECORDS)
    assert got["sweep_span_ms"] == 60.0 and got["local_energy_span_ms"] == 21.0
    assert got["grad_span_ms"] == 16.0 and got["fixed_states_span_ms"] == 6.0
    assert got["kfac_update_span_ms"] == 9.0
    # Each block's period less its top-level spans (the nested fixed_states is
    # inside gradient): 5, 4 and 13 ms an iteration.
    assert got["loop_rest_ms"] == pytest.approx(5.0)


def test_loop_rest_is_the_period_less_the_top_level_spans(monkeypatch):
    one = [record(1000.0, sweep=500.0, local_energy=200.0, gradient=150.0, fixed_states=50.0)]
    got = reading(monkeypatch, one)
    assert got["loop_rest_ms"] == pytest.approx((1000.0 - 500.0 - 200.0 - 150.0) / LENGTH)
    assert got["kfac_update_span_ms"] is None  # inference: no update span


@pytest.mark.parametrize("records", [[], RECORDS[3:]])
def test_nothing_qualifies_nothing_read(monkeypatch, records):
    assert set(reading(monkeypatch, records).values()) == {None}


def test_a_program_without_spans_reads_none(monkeypatch):
    import deephall_tpu_torch
    from deephall_tpu_torch import tracing

    monkeypatch.setattr(tracing, "blocks", lambda: RECORDS)
    monkeypatch.delattr(deephall_tpu_torch, "tracing")
    monkeypatch.setitem(sys.modules, "deephall_tpu_torch.tracing", None)  # the import fails
    context = SimpleNamespace(cfg=cfg())
    for name in [*NEW, "loop_rest_ms"]:
        assert cells.metric_reader(name)(context) is None


def test_a_cpu_run_of_the_sector6_cell_reads_its_spans():
    """Fixed states, penalties and KFAC at 8 walkers, the windows' blocks read
    as the traced run reads them: the top-level spans and the rest add up to
    the median period an iteration."""
    from deephall_tpu_torch import tracing

    cell = cells.load_cell("n6q15.sector6_train")
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    result = run.drive(cell, 2**31 + 7, 3.0, torch.device("cpu"), batch=8)
    records = [r for r in spans.qualifying(tracing.blocks(), result.cfg.optim.block_size)
               if r.index > before]
    assert records  # the warm-up block, and the window's but its last
    context = SimpleNamespace(cfg=result.cfg)
    got = {name: cells.metric_reader(name)(context) for name in [*NEW, "loop_rest_ms"]}
    assert all(value is not None and value > 0 for value in got.values()), got
    assert got["fixed_states_span_ms"] < got["grad_span_ms"]
    top = ("sweep", "local_energy", "gradient", "update")
    rest = [(r.period_ms - sum(r.spans[name].ms for name in top)) / r.length for r in records]
    assert got["loop_rest_ms"] == pytest.approx(statistics.median(rest))
    assert got["loop_rest_ms"] < statistics.median(r.period_ms / r.length for r in records)
