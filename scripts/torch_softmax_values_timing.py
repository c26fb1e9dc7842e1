#!/usr/bin/env python3
"""Time the jet softmax/values kernels at the shapes of N = 6 to 16 on the card.

    python3 scripts/torch_softmax_values_timing.py [--batch 3360] [--reps 10]
        [--other-source CHECKOUT/deephall_tpu_torch/csrc/jet_attention.cu]

For each shape ``(N, C, E)`` (T = N tokens, D = 256, 4 heads of 64) it makes
random ``qkv`` planes and prints one JSON line: the wrapper
``ops/jet_attention.py:softmax_values`` (the tiled kernel at T = 6, the
streamed kernel elsewhere, with the heads of an item and the stages of the
ring the library chose) and its plain version, their CUDA-event medians, the
largest error relative to the plain output's largest value, and the bound of
``attention_work`` as ``chip_smoke.py`` takes it.  At N = 10 in both modes it
also times the streamed kernel's parts (``softmax_values_probe``): without
its stores, without its arithmetic, and at every head group and stage count
that fits.  With ``--other-source`` the ``jet_softmax_values_f32`` entry point
of that source (an older commit unpacked with ``git archive``) is built by
``nvcc`` beside this checkout's kernels and timed on the same inputs in turns
with this checkout's kernel (this, other, other, this), or reported as
refused with its CUDA error.  The card's name and power limit close the
output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# (N, C, E): both jet modes of N = 6, 8, 10, 12 and 16 (C = 2N + E).
SHAPES = ((6, 15, 3), (6, 13, 1), (8, 19, 3), (8, 17, 1), (10, 23, 3), (10, 21, 1),
          (12, 27, 3), (12, 25, 1), (16, 35, 3))
FEAT, HEADS = 256, 4


def other_kernel(source: Path):
    """``jet_softmax_values_f32`` of another source file, built by ``nvcc``."""
    from deephall_tpu_torch.ops import _build
    from deephall_tpu_torch.ops.jet_attention import _SV_ARGTYPES

    out = _build.BUILD_DIR / "other" / "libjet_attention_other.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(out), str(source)],
                   check=True, capture_output=True, text=True)
    fn = ctypes.CDLL(str(out)).jet_softmax_values_f32
    fn.argtypes = list(_SV_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def parts(ja, qkv, batch: int, n: int, c: int, e: int, reps: int) -> dict:
    """The streamed kernel whole, without its stores and without its arithmetic,
    then whole at every head group (a divisor of the heads) and stage count
    that fits one block, in ms."""
    def probe(name, group=0, stages=0):
        return chip_smoke.cuda_ms(
            lambda: ja.softmax_values_probe(qkv, batch, n, HEADS, c, e, name, group, stages), reps=reps)

    out = {name: probe(name) for name in ja.STREAMED_PROBES}
    for group in (g for g in range(1, HEADS + 1) if HEADS % g == 0):
        for stages in range(1, ja.SV_MAX_STAGES + 1):
            if ja.softmax_values_smem(n, FEAT // HEADS, group, stages) <= ja.SV_SMEM_LIMIT:
                out[f"group{group}_stages{stages}"] = probe("whole", group, stages)
    return out


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--batch", type=int, default=3360, help="walkers (default: 3360)")
    parser.add_argument("--reps", type=int, default=10, help="timed calls a route (default: 10)")
    parser.add_argument("--other-source", type=Path, default=None,
                        help="a jet_attention.cu whose generic entry point is timed beside")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_softmax_values_timing: no CUDA card", file=sys.stderr)
        return 1
    from deephall_tpu_torch import train  # noqa: F401  (switches TF32 off)
    from deephall_tpu_torch.ops import _build
    from deephall_tpu_torch.ops import jet_attention as ja

    device = torch.device("cuda", 0)
    rates = chip_smoke.peaks(torch.cuda.get_device_name(0))
    _build.build()
    other = other_kernel(args.other_source) if args.other_source else None
    batch = args.batch
    for n, c, e in SHAPES:
        planes = c + e + 2
        gen = torch.Generator(device=device).manual_seed(n + 100 * c)
        qkv = torch.randn(planes * batch * n, 3 * FEAT, generator=gen, device=device)
        qkv[:, :FEAT] /= math.sqrt(FEAT // HEADS)  # q carries 1/sqrt(dh)
        want = ja.softmax_values_plain(qkv, batch, n, HEADS, c, e)
        tiled_before = ja.softmax_values.launches_tiled
        got = ja.softmax_values(qkv, batch, n, HEADS, c, e)
        torch.cuda.synchronize()
        scale = want.abs().max().item()
        nbytes, core, _ = ja.attention_work(batch, n, FEAT, HEADS, c, e)
        elems = planes * batch * n * FEAT
        bound_ms, bound_by = chip_smoke.bound(4 * elems * 4, core, rates)
        routed = lambda: ja.softmax_values(qkv, batch, n, HEADS, c, e)  # noqa: E731
        row = dict(
            n=n, c=c, e=e, batch=batch, tiled=ja.softmax_values.launches_tiled > tiled_before,
            max_rel_err=(got - want).abs().max().item() / scale,
            ms=chip_smoke.cuda_ms(routed, reps=args.reps),
            plain_ms=chip_smoke.cuda_ms(
                lambda: ja.softmax_values_plain(qkv, batch, n, HEADS, c, e), reps=3),
            bound_ms=bound_ms, bound_by=bound_by,
        )
        del want, got
        if not row["tiled"]:
            group, stages, threads = ja.streamed_plan(device, n, FEAT, HEADS)
            row.update(group=group, stages=stages, threads=threads,
                       smem_bytes=ja.softmax_values_smem(n, FEAT // HEADS, group, stages))
        if n == 10:
            row["parts_ms"] = parts(ja, qkv, batch, n, c, e, args.reps)
        if other is not None:
            out = torch.empty(planes * batch * n, FEAT, device=device)

            def call():
                return other(qkv.data_ptr(), out.data_ptr(), planes, batch, n, FEAT, HEADS, c, e,
                             torch.cuda.current_stream(device).cuda_stream)

            status = call()
            torch.cuda.synchronize()
            if status:
                row["other_status"] = f"refused: CUDA error {status}"
            else:
                want = ja.softmax_values_plain(qkv, batch, n, HEADS, c, e)
                row["other_max_rel_err"] = (out - want).abs().max().item() / want.abs().max().item()
                del want
                turns = [chip_smoke.cuda_ms(f, reps=args.reps) for f in (routed, call, call, routed)]
                row.update(turns_ms=turns, ms=(turns[0] + turns[3]) / 2, other_ms=(turns[1] + turns[2]) / 2)
        print(json.dumps(row), flush=True)
        del qkv
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
