#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, for one cell, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 ... [--fault-seeds 3]
        [--control-seeds 3] [--seconds 3] [--out <file.jsonl>]

For each seed the program runs as ``benchmark/run.py`` runs it (set-up, its
recorded iterations, a short window at the cell's own load) and its numbers
are read against the float64 reference.  For the first ``--control-seeds``
seeds the control is read too: the reference itself, put in the program's
place and computed in float32 with TF32 products, against the float64
reference on the same walkers.  For the first ``--fault-seeds`` seeds each
fault of :data:`benchmark.harness.port.FAULTS` that the cell can have is
planted under the block and its numbers read.  One JSON line a reading.

The benchmark's own runs do not run this.  It needs the card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark import run as bench  # noqa: E402
from benchmark.harness import cells, check, port  # noqa: E402


def readings(cell, seed, seconds, device, fault=None, control=False) -> list[dict]:
    t0 = time.time()
    run = bench.drive(cell, seed, seconds, device, fault=fault)
    report = {}
    values, control_values = bench.compare(cell, run, seed, device, control=control, report=report)
    out = [{"seed": seed, "kind": fault or "program", **values, **report, "seconds": time.time() - t0,
            "blocks": len(run.window.blocks), "energy": run.records[0].row["energy"].real}]
    if control_values is not None:
        out.append({"seed": seed, "kind": "control", **control_values, **report.get("control", {})})
    return out


def main(argv=None) -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--fault-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibration needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    cell = cells.load_cell(args.workload)
    # An inference step returns its state unchanged by design.
    faults = [f for f in port.FAULTS if check.is_training(cell) or f != "unchanged"]
    with open(args.out, "a") if args.out else contextlib.nullcontext() as out:
        for i, seed in enumerate(args.seeds):
            lines = readings(cell, seed, args.seconds, device, control=i < args.control_seeds)
            if i < args.fault_seeds:
                for fault in faults:
                    lines += readings(cell, seed, args.seconds, device, fault=fault)
            for line in lines:
                text = json.dumps({"workload": cell.name, **line})
                print(text, flush=True)
                if out:
                    out.write(text + "\n")
                    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
