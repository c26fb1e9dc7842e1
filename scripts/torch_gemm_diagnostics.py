#!/usr/bin/env python3
"""Where the tensor-core ``jet_gemm`` of the PyTorch port spends its time, on one CUDA card.

    python3 scripts/torch_gemm_diagnostics.py

Builds the kernel of ``deephall_tpu_torch/csrc/jet_attention.cu`` as it is and
three cut-down copies of it (made by text substitution into
``build/deephall_tpu_torch/diagnostics``, compiled in parallel), and times each
at the production shapes (M = P * 3360 * 6 rows, K = 256, N = 768 and 256, in
both jet modes) beside ``torch.matmul``:

- ``kernel``: the kernel as shipped (its result is checked against float64);
- ``no_store``: the epilogue computes but does not write C;
- ``products_only``: the ring is filled once and never again, so the loop is
  the wgmma stream, the barriers and the stores: what the tensor cores can do
  for this instruction mix;
- ``loads_only``: the cp.async ring and the operand splits without any wgmma.

The cut-down copies give wrong results by construction; only their times are
read.  One JSON line per shape; the card's name and power limit come first.
Imports nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deephall_tpu_torch.ops import _build  # noqa: E402
from deephall_tpu_torch.ops import jet_attention as ja  # noqa: E402

STORE = "if (row < M) *reinterpret_cast<float4*>(C + row * N + col) = out;"
REFILL = "    load_stage(f + 2);\n"
OPERAND = "      load_a(f, r, hi, lo);\n"
PROLOGUE = "  int step_in_tile = 0, tiles_done = 0;\n"
PRODUCTS_START = "      wgmma_m64n128k8(d, lo[4 * kk]"
PRODUCTS_END = "dhi + 2 * kk, 1);"


def substitute(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise RuntimeError(f"the kernel source no longer has exactly one {old!r}")
    return text.replace(old, new)


def variants(source: str) -> dict[str, str]:
    start = source.index(PRODUCTS_START)
    end = source.index(PRODUCTS_END, start) + len(PRODUCTS_END)
    products_only = substitute(source, REFILL, "    cp_async_commit();\n")
    products_only = substitute(products_only, OPERAND, "")
    products_only = substitute(products_only, PROLOGUE, "  load_a(0, 0, hi, lo);\n" + PROLOGUE)
    keep_registers = ("      d[kk] += __uint_as_float(hi[4 * kk] ^ lo[4 * kk + 1]) +"
                      " __uint_as_float(hi[4 * kk + 2] ^ lo[4 * kk + 3]) + f;")
    return {
        "kernel": source,
        "no_store": substitute(source, STORE, STORE.replace("row < M", "row < M && bias_rows < -1")),
        "products_only": products_only,
        "loads_only": source[:start] + keep_registers + source[end:],
    }


def build(texts: dict[str, str]) -> dict:
    out_dir = _build.BUILD_DIR / "diagnostics"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, text in texts.items():
        src, lib = out_dir / f"{name}.cu", out_dir / f"{name}.so"
        src.write_text(text)
        jobs[name] = (lib, subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    functions = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(lib)).jet_gemm_tf32x3
        fn.argtypes, fn.restype = list(ja._GEMM_TC_ARGTYPES), ctypes.c_int
        functions[name] = fn
    return functions


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


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_gemm_diagnostics: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    functions = build(variants((_build.CSRC / "jet_attention.cu").read_text()))
    device = torch.device("cuda", 0)
    gen = torch.Generator(device=device).manual_seed(0)
    stream = torch.cuda.current_stream(device).cuda_stream
    k = 256
    for planes in (20, 16):
        for n in (768, 256):
            m = planes * 3360 * 6
            a = torch.randn(m, k, generator=gen, device=device)
            w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
            bias = torch.randn(n, generator=gen, device=device) * 0.1
            split = ja.split_weight(w)
            out = torch.empty(m, n, device=device)
            row = {"m": m, "k": k, "n": n, "matmul_ms": cuda_ms(lambda: torch.matmul(a, w))}
            for name, fn in functions.items():
                def call(fn=fn):
                    status = fn(a.data_ptr(), split.hi.data_ptr(), split.lo.data_ptr(), bias.data_ptr(),
                                out.data_ptr(), m, n, k, m // planes, stream)
                    if status:
                        raise RuntimeError(f"{name}: CUDA error {status}")
                row[f"{name}_ms"] = cuda_ms(call)
                if name == "kernel":
                    want = a.double() @ w.double()
                    want[: m // planes] += bias.double()
                    row["kernel_rel_err"] = ((out - want).abs().max() / want.abs().max()).item()
                    del want
            print(json.dumps(row), flush=True)
            del a, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
