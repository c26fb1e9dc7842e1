#!/usr/bin/env python3
"""The benchmark of ``deephall_tpu_torch``: VMC iterations per second on one H100.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration and a job, each a file of its own (:mod:`benchmark.harness.cells`).
The run restores the job's checkpoint into the port's program, drives it
through its first iterations as blocks of one and warms up one block (all
set-up), then runs blocks of the job's length for ``--seconds`` (the window),
and then holds what the program produced against the plain reference
(:mod:`benchmark.harness.check`).

``--trace 0`` reports the cell's end-to-end metrics: ``iters_per_s`` (the
window's iterations over its wall time), ``peak_mem_gib``
(``torch.cuda.max_memory_allocated`` over set-up and window) and ``setup_s``
(from the start of the process to the start of the window).  ``--trace 1``
runs the same window, then profiles one more block with ``torch.profiler``
(its trace under ``TMPDIR``, deleted once read), times the iteration's parts
with CUDA events, and reports the cell's per-layer metrics, each read by
``benchmark/metrics/<metric>.py``.

The last line of standard output is one JSON object; the numbers that decide
``correct`` are the last key there and the last lines of standard error.  It
fails, and prints no result, without a CUDA card, without the port, or if
``jax``, ``jaxlib``, ``flax`` or ``deephall_tpu`` was imported.
"""

from __future__ import annotations

import time

START = time.time()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.harness import cells  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "deephall_tpu")
GIB = 2**30


def forbidden_modules() -> list[str]:
    """The forbidden top-level packages in ``sys.modules``, compared by whole name."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def drive(cell: cells.Cell, seed: int, seconds: float, device, batch: int | None = None,
          fault: str | None = None, trace: bool = False) -> SimpleNamespace:
    """Set-up, the window and, with ``trace``, the profiled block and the parts.

    ``batch`` and ``fault`` are for the tests and the calibration
    (:mod:`benchmark.calibrate`): fewer walkers, and a fault planted under the
    block (:data:`benchmark.harness.port.FAULTS`)."""
    import torch

    from benchmark.harness import port

    setup = port.build(cell, seed, device, batch=batch, fault=fault)
    theta0, records = port.record_steps(setup, cell.job["recorded_steps"])
    port.run_block(setup, setup.cfg.optim.block_size)  # warm-up at the window's shapes
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    window_start = time.time()
    win = port.window(setup, seconds, device)
    out = SimpleNamespace(setup_s=window_start - START, window=win, theta0=theta0, records=records,
                          cfg=setup.cfg, training=port.training(setup), summary=None, parts=None,
                          memory_peak_bytes=None)
    if device.type == "cuda":
        out.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    phases = {"setup_s": out.setup_s, "window_s": time.time() - window_start}
    if trace:
        now = time.time()
        out.summary = profile_block(setup, device)
        out.parts = port.part_times(setup, device)
        phases["trace_s"] = time.time() - now
    print("phases " + json.dumps(phases), file=sys.stderr)
    del setup
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def profile_block(setup, device) -> dict:
    """One block under ``torch.profiler``, summarised (:mod:`benchmark.harness.trace`)."""
    import torch

    from benchmark.harness import port, trace

    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    folder = tempfile.mkdtemp(prefix="trace-")
    try:
        with torch.profiler.profile(activities=activities) as prof:
            port.run_block(setup, setup.cfg.optim.block_size)
            torch.cuda.synchronize(device)
        path = Path(folder) / "trace.json"
        prof.export_chrome_trace(str(path))
        del prof
        return trace.summarise(trace.load_events(path), top=10, iters=setup.cfg.optim.block_size)
    finally:
        shutil.rmtree(folder, ignore_errors=True)


def compare(cell: cells.Cell, run: SimpleNamespace, seed: int, device, control: bool = False,
            report: dict | None = None):
    """The numbers of the program's recorded iterations, and in inference of a
    sample of the window's blocks drawn from ``seed``, against the reference;
    with ``control``, also those of the control on the same walkers.
    ``report`` gets the worst leaves of the training numbers."""
    import torch

    from benchmark.harness import check

    blocks = run.window.blocks
    sample = []
    if not run.training and blocks and cell.job["checked_blocks"]:
        rng = random.Random(seed)
        rest = rng.sample(range(len(blocks) - 1), min(cell.job["checked_blocks"] - 1, len(blocks) - 1))
        sample = [blocks[i] for i in sorted(rest)] + [blocks[-1]]
    walkers = [r.x_after for r in run.records] + [x for x, _ in sample]
    rows = cell.job["reference_rows"]
    judge = check.reference_chain(cell, walkers, device, rows=rows)
    program = check.program_chain(run.theta0, run.records, [row for _, row in sample])
    values = check.numbers(cell, program, judge, report)
    values["sweep_gap"] = check.sweep_gap(cell, run.records[0], device, run.cfg.mcmc.steps)
    if not control:
        return values, None
    candidate = check.reference_chain(cell, walkers, device, dtype=torch.float32, tf32=True, rows=rows)
    return values, check.numbers(cell, candidate, judge, None if report is None else report.setdefault("control", {}))


def decide(cell: cells.Cell, run: SimpleNamespace, seed: int, device) -> tuple[bool, dict]:
    """``(correct, {number: {value, limit}})``."""
    from benchmark.harness import check

    return check.judged(compare(cell, run, seed, device)[0], cell.limits)


def metric_line(cell: cells.Cell, run: SimpleNamespace, trace: bool) -> dict:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer ones."""
    if not trace:
        values = {"iters_per_s": run.window.iterations / run.window.seconds,
                  "peak_mem_gib": run.memory_peak_bytes / GIB, "setup_s": run.setup_s}
        return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    work_file = cells.work_path(cell.config_name, cell.job_name)
    context = SimpleNamespace(
        cell=cell, cfg=run.cfg, training=run.training, summary=run.summary, parts=run.parts,
        iterations_traced=run.cfg.optim.block_size,
        iteration_ms=1e3 * run.window.seconds / run.window.iterations,
        work=json.loads(work_file.read_text()) if work_file.exists() else None)
    out = {}
    for m in cell.per_layer:
        value = cells.metric_reader(m["name"])(context)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def breakdown(summary: dict) -> dict:
    return {"device_ops": [[row["name"][:120], row["ms"] / 1e3] for row in summary["top"][:10]],
            "idle_gaps": [[gap["host_op"] or "none", gap["ms"] / 1e3] for gap in summary["gaps"][:10]]}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    cell = cells.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} found: nothing measured",
              file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    torch.cuda.init()
    torch.cuda.set_device(device)
    torch.cuda.reset_peak_memory_stats(device)
    run = drive(cell, args.seed, args.seconds, device, trace=bool(args.trace))
    if not run.window.iterations:
        print(f"no block completed inside {args.seconds} s: nothing measured", file=sys.stderr)
        return 4
    metrics = metric_line(cell, run, bool(args.trace))
    failed = sum(1 for row in run.window.rows if not math.isfinite(row["energy"].real))
    now = time.time()
    correct, table = decide(cell, run, args.seed, device)
    print(f"phases {{\"reference_s\": {time.time() - now}}}", file=sys.stderr)
    correct = correct and failed == 0
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": cell.chips,
           "memory_peak_bytes": run.memory_peak_bytes}
    result = {"correct": correct, "attempted": run.window.iterations, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace:
        dev["busy_s"] = run.summary["device_busy_ms"] / 1e3
        dev["window_s"] = run.summary["window_ms"] / 1e3
        result["breakdown"] = breakdown(run.summary)
    result["checks"] = table
    found = forbidden_modules()
    if found:
        print(f"forbidden modules imported: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
