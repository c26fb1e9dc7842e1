"""Capture a ``torch.profiler`` trace of steady-state production blocks on the card.

The port's counterpart of ``scripts/capture_trace.py``: it builds the block of
``scripts/torch_production_block.py`` (N=6, 2Q=15, batch 3360, KFAC, 10
moves an iteration, bf16 sweep), runs two blocks of 10 to warm up, then
traces ``--blocks`` blocks through ``train.Profile`` (the ``log.profile_dir``
profiler of the training loop, over the window that covers them) and writes
``OUT/trace.json``; summarise it with ``scripts/torch_trace_summary.py``.

    python3 scripts/torch_capture_trace.py --out DIR [--l2] [--blocks 2]

It runs on the card unless ``--device cpu`` is given (for the tests; a CPU
trace has no device events), and fails without a card.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parent.parent)]

WARMUP_BLOCKS = 2


def capture(out: str | Path, compute_l2: bool, blocks: int, device, **overrides) -> Path:
    """Trace ``blocks`` production blocks after the warm-up; returns the trace's path.

    ``overrides`` are ``torch_production_block.production_config``'s keywords.
    """
    from deephall_tpu_torch import train
    from torch_production_block import BLOCK, build_production_block

    cfg, block, state, _, pmoves, t = build_production_block(compute_l2, BLOCK, device,
                                                             **overrides)
    cfg.log.profile_dir = str(out)
    cfg.log.profile_start = WARMUP_BLOCKS * BLOCK
    cfg.log.profile_steps = blocks * BLOCK
    profile = train.Profile(cfg, state.data.device)
    try:
        for i in range(WARMUP_BLOCKS + blocks):
            profile.before_block(i * BLOCK, BLOCK)
            state, pmoves, t, stats, _ = block(state, pmoves, t, BLOCK)
            # One host read a block, as the training loop's statistics.
            float(stats["energy"].real[-1])
    finally:
        profile.stop()
    return Path(out) / "trace.json"


def main(argv: list[str] | None = None) -> Path:
    from deephall_tpu_torch.utils import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", required=True, help="directory for trace.json")
    parser.add_argument("--l2", action="store_true", help="L^2-every-step mode")
    parser.add_argument("--blocks", type=int, default=2)
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    path = capture(args.out, args.l2, args.blocks, device)
    print(f"trace written to {path} ({args.blocks} blocks of 10)")
    return path


if __name__ == "__main__":
    main()
