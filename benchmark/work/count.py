"""Count the operations of one iteration of a cell's block on the CPU, and
store them beside its configuration.

The cell's program (:mod:`benchmark.harness.port`) is built on the CPU,
where every kernel wrapper of the port takes its plain version, from the
first walkers of its checkpoint; after one iteration uncounted, a block of
the job's length runs under :class:`benchmark.work.counter.OpCounter`.  The
count is affine in the walkers (the sorts apart, which are carried with
their lengths), so it is taken at 16 and 32 walkers, carried to the
configuration's batch, and checked against the count at 48.

    python3 benchmark/work/count.py <workload> [--write]

``--write`` stores ``benchmark/work/counts/<config>/<traffic>.json``: the
operations, transcendentals and bytes of one iteration by class, and their
least times at the H100's peaks (``operations_ms`` is the numerator of the
whole step's share of the peak, ``step_mfu``).  It counts on the CPU by
design and measures no device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark.harness import cells, port  # noqa: E402
from benchmark.work import counter  # noqa: E402


def count_block(cell: cells.Cell, batch: int) -> counter.Count:
    setup = port.build(cell, seed=0, device=torch.device("cpu"), batch=batch)
    length = setup.cfg.optim.block_size
    state, pmoves, t = setup.carry

    def block(n):
        return setup.program.block(state, pmoves, t, n, setup.penalties)

    state, pmoves, t, _, _ = block(1)  # the process's constants are made once
    return counter.counted(lambda: block(length))[0], length


def per_iteration(cell: cells.Cell, batches=counter.COUNT_BATCHES) -> dict:
    """One iteration's count at the configuration's batch, checked at a third batch."""
    target = cell.config["batch_size"]
    runs = {b: count_block(cell, b) for b in batches}
    b0, b1, b2 = batches
    length = runs[b0][1]
    carried = counter.carry(runs[b0][0], runs[b1][0], (b0, b1), target)
    check = counter.carry(runs[b0][0], runs[b1][0], (b0, b1), b2)
    measured = runs[b2][0].affine()
    measured["other float32"] += counter.sort_flops(runs[b2][0].sorts)
    if check != measured:
        raise ValueError(f"the count is not affine in the walkers: carried {check} != counted {measured}")
    whole = {}
    for key, value in carried.items():
        if value % length:
            raise ValueError(f"{key}: the block's {value} is not {length} equal iterations")
        whole[key] = value // length
    return whole


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("workload")
    parser.add_argument("--write", action="store_true")
    args = parser.parse_args(argv)
    cell = cells.load_cell(args.workload)
    count = per_iteration(cell)
    result = {"config": cell.config_name, "traffic": cell.job_name, "batch": cell.config["batch_size"],
              "counted_at": list(counter.COUNT_BATCHES), "device": "cpu (counted from shapes)",
              **counter.summary(count)}
    text = json.dumps(result, indent=1, sort_keys=True)
    if args.write:
        path = cells.work_path(cell.config_name, cell.job_name)
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(text + "\n")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
