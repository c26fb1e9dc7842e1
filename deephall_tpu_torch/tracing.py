"""Spans at the port's layer boundaries: names in a profiler trace, and a
device clock inside the iteration block.

``span(name)`` marks one layer of an iteration (``sweep``, ``local_energy``,
``gradient``, ``fixed_states``, ``update``) or a part of one (``orbitals``,
the jet's orbital head and determinants in ``local_energy``;
``orbital_factors``, KFAC's orbital-head blocks in ``update``).  It does two
things:

* while a ``torch.profiler`` is active it opens the range
  ``deephall.<name>`` (``torch.profiler.record_function``), which lands in
  the Chrome trace beside the device's kernels, on the profiler's clock;
* inside an open block record (:func:`block`, which
  ``train.make_iteration_block`` opens once a call) it records a pair of
  timing CUDA events on the current stream, or reads ``time.perf_counter()``
  on the CPU, where work runs in order.

Outside a block a span times nothing, and with no profiler active it opens no
range: one check of ``torch.autograd._profiler_enabled()``.

The events come from a pool reused from block to block.  Nothing inside a
block waits for the device: a block's events are read at a later block's
start once ``query`` says they are complete (the caller's host read between
blocks has waited for them), or by :func:`blocks`, which synchronises first.
The records of the last :data:`RING` blocks stay on the host; :func:`blocks`
returns them, each with the device-clock ms of every span name summed over
the block, its calls, its parent span, and ``period_ms``, from this block's
start to the next one's (``None`` until a next block starts).

``count(name)`` counts an event in the open block record, such as how each
sweep ran (``sweep.replayed``, ``sweep.captured``, ``sweep.eager``;
``mcmc.GraphedSweep``), the orbital head's kernel calls and their harmonic
ranges (``orbitals.fused``, ``orbitals.range``; ``ops/orbital_head.py``) and
KFAC's factors (``kfac.factors``, ``kfac.gram``); each record returns its
counts as ``counts``.
"""

from __future__ import annotations

import collections
import contextlib
import time
from typing import NamedTuple

import torch

PREFIX = "deephall."
RING = 512  # block records kept: a production run's blocks, bounded


class SpanTime(NamedTuple):
    ms: float  # summed over the block's calls
    calls: int
    parent: str | None  # the span open around it, if any


class Block(NamedTuple):
    index: int  # counts every block the process opened
    length: int  # iterations
    profiled: bool  # a profiler was active at its start
    spans: dict  # {name: SpanTime}
    period_ms: float | None  # from its start to the next block's start
    counts: dict = {}  # {name: count} of :func:`count`; read only


class _Record:
    """One block's clock while it runs and until its events are read."""

    def __init__(self, recorder: Recorder, index: int, length: int, device: torch.device):
        self.recorder, self.index, self.length = recorder, index, length
        self.profiled = torch.autograd._profiler_enabled()
        self.device = device
        self.cuda = device.type == "cuda"
        self.ms: dict[str, float] = {}
        self.calls: dict[str, int] = {}
        self.parent: dict[str, str | None] = {}
        self.counts: dict[str, int] = {}
        self.stack: list[str] = []
        self.pairs: list = []  # (name, parent, start event, end event), not yet read
        self.start = self.now()
        self.next_start = None  # the next block's start, once it has one
        self.period_ms: float | None = None
        self.no_period = False  # the next block ran elsewhere

    def now(self):
        if not self.cuda:
            return time.perf_counter()
        event = self.recorder.event(self.device)
        event.record(torch.cuda.current_stream(self.device))
        return event

    def add(self, name: str, parent: str | None, ms: float) -> None:
        self.ms[name] = self.ms.get(name, 0.0) + ms
        self.calls[name] = self.calls.get(name, 0) + 1
        self.parent.setdefault(name, parent)

    @contextlib.contextmanager
    def span(self, name: str):
        parent = self.stack[-1] if self.stack else None
        self.stack.append(name)
        start = self.now()
        try:
            yield
        finally:
            self.stack.pop()
            end = self.now()
            if self.cuda:
                self.pairs.append((name, parent, start, end))
            else:
                self.add(name, parent, 1e3 * (end - start))

    def follow(self, successor: _Record) -> None:
        """``successor`` started: the end of this block's period."""
        if successor.device != self.device:
            self.no_period = True
        elif self.cuda:
            self.next_start = successor.start
        else:
            self.period_ms = 1e3 * (successor.start - self.start)

    def resolve(self) -> bool:
        """Read what has completed; ``True`` once nothing is left to read."""
        if self.pairs and all(s.query() and e.query() for _, _, s, e in self.pairs):
            for name, parent, start, end in self.pairs:
                self.add(name, parent, start.elapsed_time(end))
                self.recorder.release(self.device, start, end)
            self.pairs = []
        if (self.period_ms is None and self.next_start is not None
                and self.start.query() and self.next_start.query()):
            self.period_ms = self.start.elapsed_time(self.next_start)
            self.recorder.release(self.device, self.start)
        return not self.pairs and (self.period_ms is not None or self.no_period)

    def block(self) -> Block:
        spans = {name: SpanTime(ms, self.calls[name], self.parent[name])
                 for name, ms in self.ms.items()}
        return Block(self.index, self.length, self.profiled, spans, self.period_ms,
                     dict(self.counts))


class Recorder:
    """The block records of one process: the open one, the ring, the event pool."""

    def __init__(self, ring: int = RING):
        self.ring: collections.deque[_Record] = collections.deque(maxlen=ring)
        self.open: _Record | None = None
        self.unread: collections.deque[_Record] = collections.deque()  # events still out
        self.pool: dict[torch.device, list] = {}
        self.demand: dict[torch.device, int] = {}  # the most events one block took
        self.count = 0

    def event(self, device: torch.device):
        free = self.pool.setdefault(device, [])
        return free.pop() if free else torch.cuda.Event(enable_timing=True)

    def release(self, device: torch.device, *events) -> None:
        self.pool.setdefault(device, []).extend(events)

    def read(self) -> None:
        # Oldest first: a block's start event is its predecessor's period end.
        self.unread = collections.deque(r for r in self.unread if not r.resolve())

    def begin(self, length: int, device: torch.device) -> _Record | None:
        if self.open is not None:  # a block inside a block: the outer one records
            return None
        self.read()
        if device.type == "cuda":  # this block's events, made before it starts
            free = self.pool.setdefault(device, [])
            while len(free) < self.demand.get(device, 0):
                free.append(torch.cuda.Event(enable_timing=True))
        record = _Record(self, self.count, length, device)
        self.count += 1
        if self.ring:
            self.ring[-1].follow(record)
        self.open = record
        return record

    def end(self, record: _Record | None) -> None:
        if record is None:
            return
        self.open = None
        self.ring.append(record)
        if record.cuda:
            used = 1 + 2 * len(record.pairs)
            self.demand[record.device] = max(self.demand.get(record.device, 0), used)
            self.unread.append(record)

    def blocks(self) -> list[Block]:
        devices = {r.device for r in self.unread}
        for device in devices:
            torch.cuda.synchronize(device)
        self.read()
        return [r.block() for r in self.ring]


_recorder = Recorder()


@contextlib.contextmanager
def span(name: str):
    """The layer ``name``: a ``deephall.<name>`` range under an active profiler,
    and its device-clock time in the open block record."""
    named = torch.autograd._profiler_enabled()
    record = _recorder.open
    with (torch.profiler.record_function(PREFIX + name) if named else contextlib.nullcontext()), \
            (record.span(name) if record is not None else contextlib.nullcontext()):
        yield


@contextlib.contextmanager
def block(length: int, device: torch.device):
    """One block record around an iteration block of ``length`` on ``device``."""
    record = _recorder.begin(length, torch.device(device))
    try:
        yield
    finally:
        _recorder.end(record)


def count(name: str) -> None:
    """One more ``name`` in the open block record (``sweep.replayed``, ...);
    outside a block nothing is counted."""
    record = _recorder.open
    if record is not None:
        record.counts[name] = record.counts.get(name, 0) + 1


def blocks() -> list[Block]:
    """The finished block records, oldest first (at most :data:`RING`); waits
    for the device's outstanding events."""
    return _recorder.blocks()
