"""The port's layer spans (``deephall_tpu_torch/tracing.py``) on the CPU.

A tiny Psiformer (N=3, 2Q=2, 8 walkers) runs blocks of 3 through
``train.make_program``, as the CLI builds them: each block call is one record
holding the device-clock time (``time.perf_counter`` here) of its sweep, local
energy, gradient, fixed-state and update spans, and of the orbital head's
spans nested in the local energy and the update; outside a block a span
records nothing; with no profiler active no ``record_function`` range is
opened; under ``torch.profiler`` the spans are ``deephall.*`` ranges in the
trace, nested in the caller's.  The CUDA path's event bookkeeping runs on
stand-in events.  The spans change no number the block computes.
"""

from __future__ import annotations

import contextlib
import math
import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import trace  # noqa: E402
from deephall_tpu_torch import tracing, train  # noqa: E402
from deephall_tpu_torch.config import (  # noqa: E402
    Config,
    dotlist_to_dict,
    merge_dicts,
    resolve_interpolations,
    to_dict,
)
from deephall_tpu_torch.networks import make_network  # noqa: E402
from deephall_tpu_torch.types import CheckpointState  # noqa: E402
from deephall_tpu_torch.weights import init_params  # noqa: E402

torch.set_num_threads(2)

LENGTH = 3
TINY = [
    "seed=7", "batch_size=8", "system.nspins=[3,0]", "system.flux=2",
    "network.psiformer.num_layers=1", "network.psiformer.num_heads=1",
    "network.psiformer.heads_dim=4", "mcmc.steps=2", "mcmc.adapt_frequency=4",
]
LAYERS = {"sweep", "local_energy", "gradient", "update"}
# The nested spans, their parents and their calls an iteration: the jet's
# orbital head once a local energy, KFAC's head blocks once in the factor
# products and once in the solves.
NESTED = {"orbitals": ("local_energy", 1), "orbital_factors": ("update", 2)}


def nested(optimizer: str) -> set:
    return {"orbitals", "orbital_factors"} if optimizer == "kfac" else {"orbitals"}


def program(optimizer: str, fixed: bool = False):
    """``(block, state, pmoves, t, model)`` of a fresh tiny run."""
    tree = merge_dicts(to_dict(Config()), dotlist_to_dict([*TINY, f"optim.optimizer={optimizer}"]))
    cfg = Config.from_dict(resolve_interpolations(tree))
    device = torch.device("cpu")
    generator = train.run_generator(cfg, device)
    model = make_network(cfg.system, cfg.network)
    data = train.fresh_walkers(cfg, model, generator, device)
    if optimizer == "none":
        model.requires_grad_(False)
    fixed_states = None
    if fixed:
        lower = make_network(cfg.system, cfg.network)
        init_params(lower, torch.Generator().manual_seed(cfg.seed + 1))
        fixed_states = [lower.requires_grad_(False)]
    prog = train.make_program(cfg, model, generator, fixed_states)
    width = torch.tensor(float(cfg.mcmc.width))
    state = CheckpointState(None, data, prog.opt_init(model, data), width)
    pmoves = torch.zeros(cfg.mcmc.adapt_frequency)
    return prog, state, pmoves, torch.zeros((), dtype=torch.int32), model


def run_blocks(optimizer: str, fixed: bool = False, blocks: int = 1):
    """The records of ``blocks`` blocks of :data:`LENGTH`, and the last block's outputs."""
    prog, state, pmoves, t, model = program(optimizer, fixed)
    before = tracing.blocks()[-1].index if tracing.blocks() else -1
    for _ in range(blocks):
        state, pmoves, t, stats, pmove = prog.block(state, pmoves, t, LENGTH)
    records = [r for r in tracing.blocks() if r.index > before]
    return records, (state, pmoves, t, stats, pmove, model)


@pytest.mark.parametrize("optimizer", ["kfac", "adam"])
def test_a_training_block_records_its_layers(optimizer):
    (record,), _ = run_blocks(optimizer)
    assert record.length == LENGTH and not record.profiled and record.period_ms is None
    assert set(record.spans) == LAYERS | nested(optimizer)
    for name, span in record.spans.items():
        parent, calls = NESTED.get(name, (None, 1))
        assert span.calls == calls * LENGTH and span.parent == parent and span.ms > 0, name
        if parent is not None:
            assert span.ms <= record.spans[parent].ms, name


@pytest.mark.parametrize("optimizer, parent", [("kfac", "gradient"), ("adam", "gradient"),
                                               ("none", None)])
def test_fixed_states_under_the_gradient(optimizer, parent):
    (record,), _ = run_blocks(optimizer, fixed=True)
    span = record.spans["fixed_states"]
    assert span.calls == LENGTH and span.parent == parent
    if parent is not None:
        assert span.ms <= record.spans[parent].ms


def test_an_inference_block_has_no_gradient_or_update():
    (record,), _ = run_blocks("none")
    assert set(record.spans) == {"sweep", "local_energy", "orbitals"}
    assert all(span.calls == LENGTH for span in record.spans.values())


@pytest.mark.parametrize("optimizer", ["kfac", "none"])
def test_the_spans_sum_to_at_most_the_block(optimizer):
    records, _ = run_blocks(optimizer, fixed=optimizer == "kfac", blocks=3)
    assert [r.length for r in records] == [LENGTH] * 3
    assert [r.index for r in records] == list(range(records[0].index, records[0].index + 3))
    assert records[-1].period_ms is None  # no block has started since
    for record in records[:-1]:
        top = sum(span.ms for span in record.spans.values() if span.parent is None)
        assert 0 < top <= record.period_ms


def test_spans_outside_a_block_record_nothing():
    prog, state, *_ = program("kfac", fixed=True)
    before = tracing.blocks()
    with torch.no_grad(), tracing.span("sweep"):
        prog.mcmc_step(state.data, state.mcmc_width, torch.Generator().manual_seed(0))
    prog.training_step(state)
    after = tracing.blocks()
    assert tracing._recorder.open is None
    assert [r.index for r in after] == [r.index for r in before]
    assert [r.spans for r in after] == [r.spans for r in before]


def test_no_profiler_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    (record,), _ = run_blocks("kfac", fixed=True)
    assert set(record.spans) == LAYERS | {"fixed_states"} | nested("kfac")


def test_the_profiler_trace_names_the_layers(tmp_path):
    prog, state, pmoves, t, _ = program("kfac", fixed=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("block"):
            prog.block(state, pmoves, t, LENGTH)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    assert tracing.blocks()[-1].profiled
    events = trace.load_events(path)
    host = [e for e in events if e.get("cat") in trace.HOST_CATEGORIES]
    (caller,) = [e for e in host if e["name"] == "block"]
    ours = [e for e in host if e["name"].startswith(tracing.PREFIX)]
    counts = {name: sum(1 for e in ours if e["name"] == name)
              for name in {e["name"] for e in ours}}
    assert counts == {f"deephall.{name}": NESTED.get(name, (None, 1))[1] * LENGTH
                      for name in ("sweep", "local_energy", "gradient", "fixed_states", "update",
                                   "orbitals", "orbital_factors")}

    def inside(inner, outer):
        return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]

    assert all(inside(e, caller) for e in ours)
    gradients = [e for e in ours if e["name"] == "deephall.gradient"]
    for e in ours:
        if e["name"] == "deephall.fixed_states":
            assert any(inside(e, g) for g in gradients)
    for name, (parent, _) in NESTED.items():
        parents = [e for e in ours if e["name"] == f"deephall.{parent}"]
        for e in ours:
            if e["name"] == f"deephall.{name}":
                assert any(inside(e, p) for p in parents), name
    sweep = next(e for e in ours if e["name"] == "deephall.sweep")
    start, end = sweep["ts"] + 0.01 * sweep["dur"], sweep["ts"] + 0.99 * sweep["dur"]
    assert trace.spanning_host_op(host, start, end) == "deephall.sweep"


def test_the_ring_keeps_the_newest_blocks():
    for _ in range(tracing.RING + 40):
        with tracing.block(1, "cpu"), tracing.span("sweep"):
            pass
    records = tracing.blocks()
    assert len(records) == tracing.RING
    indices = [r.index for r in records]
    assert indices == list(range(indices[0], indices[0] + tracing.RING))
    assert records[-1].index == tracing._recorder.count - 1
    assert all(r.spans["sweep"].calls == 1 for r in records)
    assert all(r.period_ms is not None for r in records[:-1])


@contextlib.contextmanager
def nothing(*args):
    del args
    yield


@pytest.mark.parametrize("optimizer, fixed", [("kfac", True), ("adam", False), ("none", True)])
def test_the_spans_change_no_number(optimizer, fixed, monkeypatch):
    # The block with its spans, under a profiler, and with tracing taken out
    # (as before the spans existed): the same draws, statistics and parameters.
    _, traced = run_blocks(optimizer, fixed, blocks=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _, profiled = run_blocks(optimizer, fixed, blocks=2)
    monkeypatch.setattr(tracing, "span", nothing)
    monkeypatch.setattr(tracing, "block", nothing)
    records, bare = run_blocks(optimizer, fixed, blocks=2)
    assert records == []
    for other in (traced, profiled):
        state, pmoves, t, stats, pmove, model = other
        want_state, want_pmoves, want_t, want_stats, want_pmove, want_model = bare
        assert torch.equal(state.data, want_state.data)
        assert torch.equal(state.mcmc_width, want_state.mcmc_width)
        assert torch.equal(pmoves, want_pmoves) and torch.equal(t, want_t)
        assert torch.equal(pmove, want_pmove) and stats.keys() == want_stats.keys()
        for key, value in stats.items():
            assert torch.equal(value, want_stats[key]), key
        for (name, p), q in zip(model.named_parameters(), want_model.parameters()):
            assert torch.equal(p, q), name


class FakeEvent:
    """A timing CUDA event on a stand-in device clock: one tick a record; the
    device has completed every record up to ``done``."""

    clock = 0.0
    done = math.inf
    made = 0

    def __init__(self, enable_timing=False):
        assert enable_timing
        FakeEvent.made += 1
        self.at = None

    def record(self, stream=None):
        del stream
        self.at = FakeEvent.clock
        FakeEvent.clock += 1.0

    def query(self):
        assert tracing._recorder.open is None, "an event queried inside a block"
        return self.at is not None and self.at <= FakeEvent.done

    def elapsed_time(self, other):
        assert self.query() and other.query()
        return other.at - self.at


def test_events_are_read_once_complete_and_reused(monkeypatch):
    # The CUDA path on stand-in events: a block's spans are read at a later
    # block's start once their events have completed, its period once the
    # next block's start has; the pool stops growing after the first blocks.
    recorder = tracing.Recorder()
    monkeypatch.setattr(tracing, "_recorder", recorder)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: None)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: setattr(FakeEvent, "done", math.inf))
    monkeypatch.setattr(FakeEvent, "clock", 0.0)
    device = torch.device("cuda:0")

    def one_block(length=2):
        with tracing.block(length, device):
            for _ in range(length):
                with tracing.span("sweep"):
                    pass
                with tracing.span("gradient"), tracing.span("fixed_states"):
                    pass

    made, unread = [], []
    for i in range(8):
        # The device has completed what the host recorded before this block,
        # except before block 4, when it lags 5 records behind.
        FakeEvent.done = FakeEvent.clock - (5 if i == 4 else 1)
        one_block()
        made.append(FakeEvent.made)
        unread.append([(r.index, len(r.pairs)) for r in recorder.unread])
    # After block i: block i - 1 waits for its period's end, block i for its spans;
    # after block 4, block 3's spans wait too.
    assert unread[3] == [(2, 0), (3, 6)] and unread[5] == [(4, 0), (5, 6)]
    assert unread[4] == [(3, 6), (4, 6)]
    assert made[3] == made[2] and made[-1] == made[5]  # the pool stops growing
    records = tracing.blocks()
    assert [r.index for r in records] == list(range(8))
    assert [(r.index, len(r.pairs)) for r in recorder.unread] == [(7, 0)]  # no next block yet
    # Each block: its start, then per iteration the sweep's 2 records and the
    # nested pair's 4; 13 records from one start to the next.
    for r in records:
        assert r.spans["sweep"] == tracing.SpanTime(2.0, 2, None)
        assert r.spans["gradient"] == tracing.SpanTime(6.0, 2, None)
        assert r.spans["fixed_states"] == tracing.SpanTime(2.0, 2, "gradient")
    assert [r.period_ms for r in records] == [13.0] * 7 + [None]
