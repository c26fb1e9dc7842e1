"""Time one jet-attention layer of the port at the production shapes on the card.

The port's counterpart of ``scripts/bench_jet_attention.py``: one attention
layer at B=3360, T=6, D=256, H=4, in the lean jet mode ``(C, E) = (13, 1)``
and the L^2 mode ``(15, 3)``, through each route the port has:

* ``kernel``: ``ops/jet_attention.py:attention_jet``, the three launches of
  the hand-written CUDA kernels (the JAX script's ``pallas``);
* ``plain``: ``attention_jet_plain``, the chain of jet primitives (the JAX
  script's ``vpu`` and ``bm`` are two layouts of that chain).

Each route's time is the median of CUDA-event timings of 30 calls;
the kernel's line adds its share of the bound that ``PERF.md`` gives the
attention (bytes at 3.35 TB/s, or the core's products at 67 TFLOP/s plus the
projections as three TF32 products at 495 TFLOP/s, whichever is larger).
Standalone numbers are a first signal only: the iteration decides.

    python3 scripts/torch_bench_jet_attention.py [route ...]   (default: kernel plain)

It runs on the card unless ``--device cpu`` is given (for the tests, which
call :func:`run` at a small batch; the CPU runs the plain versions under both
names and its times are the host's clock), and fails without a card.  The last line is one
JSON object with each route's time and its output's largest deviation from
the plain route (relative to each field's largest value).
"""

from __future__ import annotations

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BATCH, T, D, H = 3360, 6, 256, 4
REPEATS = 30
SHAPES = {"lean": (13, 1), "l2": (15, 3)}
ROUTES = ("kernel", "plain")
MEMORY_RATE, FLOAT32_RATE, TF32_RATE = 3.35e12, 67e12, 495e12


def make_inputs(batch: int, channels: int, extras: int, device, seed: int = 0):
    """Weights scaled as the JAX script's, and a random jet ``x [B, T, D]``."""
    from deephall_tpu_torch.ops.fwdlap import Jet

    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale

    hd = D // H
    p = {name: {"kernel": normal(D, H, hd, scale=1 / math.sqrt(D)), "bias": normal(H, hd, scale=0.1)}
         for name in ("query", "key", "value")}
    p["out"] = {"kernel": normal(H, hd, D, scale=1 / math.sqrt(D)), "bias": normal(D, scale=0.1)}
    s = (batch, T, D)
    return p, Jet(normal(*s), normal(channels, *s), normal(*s), normal(extras, *s))


def bound_ms(batch: int, channels: int, extras: int) -> float:
    """The attention layer's least time in ms from ``attention_work``, as the
    kernel table bounds it."""
    from deephall_tpu_torch.ops.jet_attention import attention_work

    nbytes, core, products = attention_work(batch, T, D, H, channels, extras)
    return max(nbytes / MEMORY_RATE, core / FLOAT32_RATE + 3 * products / TF32_RATE) * 1e3


def time_ms(fn, device, repeats: int) -> float:
    """Median ms of ``repeats`` calls after one warm-up call."""
    fn()
    times = []
    for _ in range(repeats):
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def max_rel_err(got, want) -> float:
    """The largest ``|got - want|`` over each field's largest ``|want|``."""
    return max(((a - b).abs().max() / b.abs().max().clamp(min=1e-30)).item()
               for a, b in zip(got, want))


def run(routes, batch: int, device, repeats: int) -> dict:
    from deephall_tpu_torch.ops import jet_attention as ja

    fns = {"kernel": ja.attention_jet, "plain": ja.attention_jet_plain}
    out = {}
    for mode, (c, e) in SHAPES.items():
        p, t = make_inputs(batch, c, e, device)
        with torch.no_grad():
            want = tuple(ja.attention_jet_plain(p, H, t))
            for route in routes:
                got = tuple(fns[route](p, H, t))
                row = dict(ms=time_ms(lambda: fns[route](p, H, t), device, repeats),
                           max_rel_err=max_rel_err(got, want))
                if route == "kernel" and device.type == "cuda":
                    row["bound_ms"] = bound_ms(batch, c, e)
                    row["share_of_bound"] = row["bound_ms"] / row["ms"]
                out[f"{mode} {route}"] = row
                del got
        del p, t, want
    return out


def main(argv: list[str] | None = None) -> dict:
    from deephall_tpu_torch.utils import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("routes", nargs="*", help="kernel, plain (default: both)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    routes = args.routes or list(ROUTES)
    if set(routes) - set(ROUTES):
        parser.error(f"routes are {ROUTES}, not {routes}")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}; B={BATCH}, T={T}, D={D}, H={H}")
    result = run(routes, BATCH, device, REPEATS)
    for key, row in result.items():
        share = f"  {100 * row['share_of_bound']:5.1f}% of the bound" if "share_of_bound" in row else ""
        print(f"{key:13s} {row['ms']:8.3f} ms/layer  max rel err {row['max_rel_err']:.2e}{share}")
    print(json.dumps({"device": name, "batch": BATCH, "routes": result}))
    return result


if __name__ == "__main__":
    main()
