"""Time the jet tower's LayerNorm-like elementwise chain in two layouts on the card.

The port's counterpart of ``scripts/bench_sublane_layout.py``: the same chain
(mean over the feature axis, centre, variance, ``rsqrt``, scale, residual;
twice) on the jet planes of the production network, batch-major ``[c, B, T,
D] = [13, 3360, 6, 256]`` and token-major ``[c, T, B, D]``.  On the TPU the
question was the padding of a ``(T=6, D=256)`` tile; on an H100 it is whether
the plain jet chain's elementwise passes reach the memory rate in either
layout (they are 13 of the plain local energy's 22 ms, ``PERF.md`` section 5).

For each layout it prints the ms of one call (two chains; CUDA events over
30 calls in a row, the median of three runs), the rate computed as
the JAX script computes it (two chains, each reading and writing the tensor
once: 4 tensor sizes a call) and its share of 3.35 TB/s, and checks that both
layouts give the same numbers after the permutation.

    python3 scripts/torch_bench_sublane_layout.py

It runs on the card unless ``--device cpu`` is given (for the tests, which
call :func:`run` at a small shape; the CPU's times are the host's clock and
it prints no rate), and fails without a card.  The last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

MEMORY_RATE = 3.35e12
SHAPE = (13, 3360, 6, 256)  # [c, B, T, D]: the lean jet's planes
ITERS = 30


def chain(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm-flavoured elementwise and reduction chain over the last axis."""
    mu = torch.mean(x, dim=-1, keepdim=True)
    xc = x - mu
    var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
    return xc * torch.rsqrt(var + 1e-5) + x


def call(x: torch.Tensor) -> torch.Tensor:
    return chain(chain(x))


def measure(x: torch.Tensor, iters: int) -> float:
    """ms of one :func:`call`, the median of three runs of ``iters`` calls in a row."""
    call(x)
    runs = []
    for _ in range(3):
        if x.is_cuda:
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y = x
            for _ in range(iters):
                y = call(y)
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            y = x
            for _ in range(iters):
                y = call(y)
            runs.append((time.perf_counter() - t0) / iters * 1e3)
        del y
    return statistics.median(runs)


def run(shape, device, iters: int) -> dict:
    gen = torch.Generator(device=device).manual_seed(0)
    batch_major = torch.randn(shape, generator=gen, device=device)
    token_major = batch_major.permute(0, 2, 1, 3).contiguous()
    with torch.no_grad():
        same = call(token_major).permute(0, 2, 1, 3)
        want = call(batch_major)
        diff = (same - want).abs().max().item()
        exact = bool(torch.equal(same, want))
        scale = want.abs().max().item()
        del same, want
        nbytes = batch_major.numel() * batch_major.element_size()
        out = {"shape": list(shape), "max_abs_diff": diff, "max_abs": scale, "equal": exact}
        for name, x in (("batch-major", batch_major), ("token-major", token_major)):
            ms = measure(x, iters)
            row = {"ms": ms}
            if device.type == "cuda":
                row["gb_per_s"] = 4 * nbytes / (ms * 1e-3) / 1e9
                row["share_of_memory_rate"] = row["gb_per_s"] * 1e9 / MEMORY_RATE
            out[name] = row
    return out


def main(argv: list[str] | None = None) -> dict:
    from deephall_tpu_torch.utils import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    c, b, t, d = SHAPE
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}")
    result = {"device": name, **run(SHAPE, device, ITERS)}
    for layout, shape in (("batch-major", (c, b, t, d)), ("token-major", (c, t, b, d))):
        row = result[layout]
        rate = (f"  {row['gb_per_s']:.0f} GB/s computed, {100 * row['share_of_memory_rate']:.1f}% "
                f"of 3.35 TB/s" if "gb_per_s" in row else "")
        print(f"{layout} {list(shape)}: {row['ms']:.3f} ms{rate}")
    print(f"token-major / batch-major time: {result['token-major']['ms'] / result['batch-major']['ms']:.3f}; "
          f"after the permutation: max |diff| {result['max_abs_diff']:.3g} "
          f"({'equal' if result['equal'] else 'not equal'})")
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
