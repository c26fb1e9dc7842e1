#!/usr/bin/env python3
"""Where the streamed and staged jet LayerNorms of the port spend their time, on one CUDA card.

    python3 scripts/torch_layernorm_diagnostics.py [--staged-only]

Builds ``deephall_tpu_torch/csrc/jet_layernorm.cu`` and times, at the
production shapes (3360 walkers x 6 tokens x 256 features, with a residual, in
both jet modes), through entry points compiled from that one source:

- ``kernel``: the streamed kernel as the port launches it (its result is
  checked against the plain version first), and ``wrapper``: the same through
  ``layernorm_jet``;
- ``generic``: the generic kernel (one block per row) on the same inputs;
- ``no_store``: the streamed kernel without its stores;
- ``no_math``: the streamed kernel without its arithmetic (load, add, store);
- ``pair``: a pair of warps per row instead of one warp, with registers cut
  for three resident blocks per SM instead of two;
- ``grid_<n>``: the streamed kernel with n blocks per SM walking over the rows
  instead of one block per group of rows;
- ``same_bytes_add``: ``torch.add(T, R, out=O)`` on three buffers of the jet's
  size, what the card gives a plain pass over the same bytes.

Then the staged kernel at N = 10 (3360 walkers x 10 tokens x 256 features,
with a residual, (C, E) = (21, 1) and (23, 3)):

- ``kernel``: as the port launches it (checked against the plain version
  first), with as many stages as fit;
- ``no_store``, ``no_math``: without its stores, without its arithmetic;
- ``stages_<s>``: a ring of s stages (1 and 2);
- ``generic``: the generic kernel on the same inputs;
- ``same_bytes_add``, and ``bound_ms``: the jet's bytes (two reads and one
  write) at the card's memory rate.

The cut-down kernels give wrong results by construction; only their times are
read.  The kernel, the wrapper and the yardstick are timed in three turns, to
show the spread inside one run.  One JSON line per mode; the card's name and
power limit come first, then what ``ptxas`` said of the kernels.  Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deephall_tpu_torch.ops import _build  # noqa: E402
from deephall_tpu_torch.ops import jet_layernorm as jl  # noqa: E402
from deephall_tpu_torch.ops.fwdlap import Jet  # noqa: E402

BATCH, TOKENS, FEAT = 3360, 6, 256
WHOLE, NO_STORE, NO_MATH = 0, 1, 2  # the probe argument
ONE_WARP, PAIR = 0, 1  # the shape argument
_PROBE_ARGTYPES = jl._ARGTYPES[:-1] + (ctypes.c_int,) * 3 + (ctypes.c_void_p,)
_STAGED_PROBE_ARGTYPES = jl._ARGTYPES[:-1] + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)
STAGED_TOKENS = 10  # N = 10
STAGED_MODES = ((21, 1), (23, 3))  # (C, E): lean, with L^2
MEMORY_RATE = 3.35e12  # bytes/s of an H100 SXM (NVIDIA's data sheet)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def as_jet(planes: torch.Tensor, c: int) -> Jet:
    """The four fields as adjacent views of one ``[P, B, T, D]`` buffer."""
    return Jet(planes[0], planes[1 : 1 + c], planes[1 + c], planes[2 + c :])


def staged_row(c: int, e: int, generic, gen, device) -> dict:
    """The staged kernel's parts at N = 10 with a residual, beside the generic
    kernel and ``torch.add`` over the same bytes."""
    probe = _build.function("jet_layernorm", "jet_layernorm_staged_probe_f32", _STAGED_PROBE_ARGTYPES)
    stream = torch.cuda.current_stream(device).cuda_stream
    rows = BATCH * STAGED_TOKENS
    shape = (c + e + 2, BATCH, STAGED_TOKENS, FEAT)
    t, r = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
    out = torch.empty(shape, device=device)
    p = {"scale": torch.randn(FEAT, generator=gen, device=device) * 0.3 + 1.0,
         "bias": torch.randn(FEAT, generator=gen, device=device) * 0.1}
    jt, jr, jo = as_jet(t, c), as_jet(r, c), as_jet(out, c)
    ptrs = [v.data_ptr() for v in (*jt, *jr, p["scale"], p["bias"], *jo)]

    def staged(probe_arg=WHOLE, stages=0):
        status = probe(*ptrs, rows, FEAT, c, e, 1e-5, probe_arg, stages, stream)
        if status:
            raise RuntimeError(f"staged probe {probe_arg} stages {stages}: CUDA error {status}")

    def call_generic():
        status = generic(*ptrs, rows, FEAT, c, e, 1e-5, stream)
        if status:
            raise RuntimeError(f"generic: CUDA error {status}")

    want = jl.layernorm_jet_plain(p, jt, residual=jr)
    out.zero_()
    staged()
    torch.cuda.synchronize()
    row = {"mode": f"N10 C{c}E{e}", "rows": rows, "feat": FEAT, "residual": True,
           "stages": jl.staged_stages(device.index, FEAT, c, e, True),
           "stage_bytes": jl.stage_bytes(FEAT, c, e, True),
           "bound_ms": 3 * t.numel() * 4 / MEMORY_RATE * 1e3,
           "kernel_rel_err": max(((a - b).abs().max() / b.abs().max()).item()
                                 for a, b in zip(jo, want))}
    del want
    turns = {"kernel_ms": staged, "generic_ms": call_generic,
             "same_bytes_add_ms": lambda: torch.add(t, r, out=out)}
    for name in turns:
        row[name] = []
    for _ in range(2):
        for name, fn in turns.items():
            row[name].append(cuda_ms(fn))
    row["no_store_ms"] = cuda_ms(lambda: staged(probe_arg=NO_STORE))
    row["no_math_ms"] = cuda_ms(lambda: staged(probe_arg=NO_MATH))
    for stages in (1, 2):
        row[f"stages_{stages}_ms"] = cuda_ms(lambda: staged(stages=stages))
    row["share_of_bound"] = row["bound_ms"] / statistics.median(row["kernel_ms"])
    del t, r, out, jt, jr, jo
    torch.cuda.empty_cache()
    return row


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--staged-only", action="store_true", help="time the staged kernel alone")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_layernorm_diagnostics: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    log = Path(f"{_build.build()['jet_layernorm']}.log")
    if log.exists():
        print(json.dumps({"ptxas": [
            line.strip() for line in log.read_text().splitlines()
            if "registers" in line or "spill" in line or "Compiling entry" in line
        ]}), flush=True)
    generic = _build.function("jet_layernorm", "jet_layernorm_generic_f32", jl._ARGTYPES)
    probe = _build.function("jet_layernorm", "jet_layernorm_streamed_probe_f32", _PROBE_ARGTYPES)
    device = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    stream = torch.cuda.current_stream(device).cuda_stream
    gen = torch.Generator(device=device).manual_seed(0)
    rows = BATCH * TOKENS
    for c, e in () if args.staged_only else jl.STREAMED_MODES:
        shape = (c + e + 2, BATCH, TOKENS, FEAT)
        t, r = (torch.randn(shape, generator=gen, device=device) for _ in range(2))
        out = torch.empty(shape, device=device)
        p = {"scale": torch.randn(FEAT, generator=gen, device=device) * 0.3 + 1.0,
             "bias": torch.randn(FEAT, generator=gen, device=device) * 0.1}
        jt, jr, jo = as_jet(t, c), as_jet(r, c), as_jet(out, c)
        ptrs = [v.data_ptr() for v in (*jt, *jr, p["scale"], p["bias"], *jo)]

        def call(fn, *extra, what):
            status = fn(*ptrs, rows, FEAT, c, e, 1e-5, *extra, stream)
            if status:
                raise RuntimeError(f"{what}: CUDA error {status}")

        def streamed(probe_arg=WHOLE, shape_arg=ONE_WARP, blocks=0):
            call(probe, probe_arg, shape_arg, blocks, what=f"probe {probe_arg} {shape_arg} {blocks}")

        want = jl.layernorm_jet_plain(p, jt, residual=jr)
        row = {"mode": f"C{c}E{e}", "rows": rows, "feat": FEAT}
        for name, shape_arg in (("kernel", ONE_WARP), ("pair", PAIR)):
            out.zero_()
            streamed(shape_arg=shape_arg)
            torch.cuda.synchronize()
            row[f"{name}_rel_err"] = max(
                ((a - b).abs().max() / b.abs().max()).item() for a, b in zip(jo, want)
            )
        del want
        turns = {"kernel_ms": streamed,
                 "wrapper_ms": lambda: jl.layernorm_jet(p, jt, residual=jr),
                 "same_bytes_add_ms": lambda: torch.add(t, r, out=out)}
        for name in turns:
            row[name] = []
        for _ in range(3):
            for name, fn in turns.items():
                row[name].append(cuda_ms(fn))
        row["generic_ms"] = cuda_ms(lambda: call(generic, what="generic"))
        row["no_store_ms"] = cuda_ms(lambda: streamed(probe_arg=NO_STORE))
        row["no_math_ms"] = cuda_ms(lambda: streamed(probe_arg=NO_MATH))
        row["pair_ms"] = cuda_ms(lambda: streamed(shape_arg=PAIR))
        for per_sm in (2, 4, 8):
            row[f"grid_{per_sm}_ms"] = cuda_ms(lambda: streamed(blocks=per_sm * sms))
        print(json.dumps(row), flush=True)
        del t, r, out, jt, jr, jo
        torch.cuda.empty_cache()
    for c, e in STAGED_MODES:
        print(json.dumps(staged_row(c, e, generic, gen, device)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
