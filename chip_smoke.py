#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, one JSON line each; any failure ends the run with a non-zero exit:

1. environment: torch, the card, its power limit, the TF32 flags (both off);
2. build: compiles ``deephall_tpu_torch/csrc/*.cu`` (one nvcc each, in
   parallel); ptxas must report no spill for the staged jet LayerNorm or
   the streamed softmax/values kernel;
3. kernels: every kernel against its plain PyTorch version at the production
   shapes (B=3360 walkers, T=6, D=256, H=4) in both jet modes, (C, E) = (15, 3)
   with L^2 and (13, 1) without, with each one's time, its plain version's
   time and its bound; ``jet_gemm`` at both of its shapes (N = 3D and N = D)
   beside ``torch.matmul``; the jet LayerNorm's streamed kernel (with a
   residual) and its staged kernel (without a residual, which the streamed
   one does not take), each beside a plain pass over the same bytes
   (``torch.add``), the staged one also beside the generic kernel on the
   same inputs, timed in turns; then phase ``orbital_head``: the orbital
   head's kernel against its plain version at the four benchmark
   configurations' shapes (N=6 in both modes, N=10 with 1 and 16
   determinants, N=14 at 2Q=65 in both modes), with its time, the plain
   version's and its bound, and at N=14 each of its two harmonic-range
   passes timed alone; then
   phase ``kfac_gram``: KFAC's Gram-product kernel at the 16-determinant
   head's G (33,600 x 4,480) and at an N = 6 layer's A with its bias
   (20,160 x 256 and the ones column): exactly symmetric, within 2e-5 of the
   plain version and no farther from float64 (Frobenius) than twice it, with
   its time, its bound (the triangle's products as three TF32 products), the
   plain version's time and ``torch.matmul``'s (``library_ms``);
4. slice: the inference CLI on the converged N=6 checkpoint
   (``artifacts/prod_r4``), 20 iterations at batch 3360 with L^2 on and the
   bf16 sweep; the mean energy must lie within 0.005 of 6.8681, each
   kernel's launch count must match the iterations, and every ``jet_gemm``,
   ``jet_softmax_values`` and ``jet_layernorm`` launch must have taken the
   kernel built for this shape (tensor cores, tiled, streamed);
5. end to end: local energy and observables of the 3360 stored walkers through
   the kernels and through the plain versions, on the card; the batch means
   and the median walker must agree to 1e-4 of each observable's RMS.  Then
   phase ``psiformer_pole``: the walkers of
   ``scripts/torch_psiformer_pole_probe.py`` (electron 0 of stored walkers at
   float32 pi, 0 and 3.45e-4, 1e-3, 1e-2 from either pole; 8 ordinary ones)
   through the kernels in float32 against the plain route in float64: at
   every pole walker KE and E_L within 2e-3, L^2 within 5e-3, Lz within
   1e-3, all finite, and one local energy's launches;
6. train: the training CLI resumes ``prod_r4`` under KFAC with its stored
   curvature (step 20000 on entry, 20010 on exit) for 10 iterations at batch
   3360, L^2 on, bf16 sweep; the mean energy must lie within 0.005 of 6.8681
   with L^2 < 0.2, every step must keep ``lr^2 coeff^2 d^T F d`` within the
   norm constraint, and the launch counts must be 10 x those of one local
   energy (no burn-in, no probe), and the Gram-product kernel's 10 x two a
   Kronecker block.  On the trained walkers, against a float64
   local energy: in every observable the kernel path's median walker must lie
   no farther from float64 than 1.5x the plain float32 path's, and the L^2
   batch mean no farther than max(2x the plain path's distance, 3e-5 of its
   RMS); the kernel path's median walker must also lie within 1e-4 of the RMS
   of the plain path's, each batch mean within 5% of its standard error of
   float64's, the stored weights must read as stale, and one KFAC step with
   the kernel path's local energy must lie no farther from the step with the
   float64 one than twice the plain float32 path's.  Then 2 Adam iterations
   from the same checkpoint, which must drop the KFAC state with
   ``validate_opt_state``'s warning and stay finite.  It prints the
   iteration's median time, its split (sweep, local energy, forward with its
   two backward passes, KFAC update) and the peak memory;
7. excited: the training CLI resumes the magnetoroton sector-6 state
   (``artifacts/roton13/sector_6``: Lz = 6, the L^2 selector at 42, one fixed
   lower state, dynamic penalties) under KFAC with its stored curvature for 10
   iterations in one block of 10, with a ``torch.profiler`` trace; E, Lz, L^2
   and the overlap must match the sector's published row
   (``artifacts/roton13/dispersion.csv``), the launches must be 10 x those of
   one local energy and the trace must exist.  The same run in blocks of 1,
   and again in one block of 10 without the profiler, gives the iteration
   time at both block sizes; in both, inside the blocks and their statistics'
   host reads (checkpoint saves apart), at most one synchronising call per
   block may occur (``torch.cuda.set_sync_debug_mode``; the profiled run's
   are listed).  Beside it, 5 inference iterations of the same state with its
   fixed state (phase ``slice_excited``);
8. laughlin: the inference CLI on the analytic Laughlin state at N=6, 2Q=15
   (``network.type=laughlin``), batch 3360, L^2 on, the default burn-in and
   200 iterations, through the full-Hessian local energy: the mean energy
   within 0.001 of 6.87306 (``BASELINE.md``), L^2 < 0.005, no NaN, and on the
   last walkers the kinetic energy within 1e-3 of N/2 = 3 at the median
   walker and in the batch mean; no kernel launches.  On the pole walkers of
   ``scripts/torch_laughlin_pole_probe.py`` (one electron at pi - eps and at
   eps, eps = 1e-3, 1e-4, 1e-5) the kinetic energy within 1e-4 of 3 and
   |L^2| <= 1e-4 at every walker (the full-Hessian path runs in float64);
9. hessian: the first 336 stored walkers of ``prod_r4`` through the kernel
   jet, the plain float32 jet, the float32 full-Hessian path over the plain
   forward and the float64 full-Hessian path: the kernel jet within 1e-4 of
   each observable's RMS of the float32 Hessian path (median walker and batch
   mean), and no farther from float64 than phase ``train`` allows against the
   plain jet's distance; the kernels launched once each local energy's worth;
10. ed_state: the exact ED ground state of N=6, 2Q=15 (Lz = 0, 338
   determinants) in complex128 on the same walkers through the full-Hessian
   path: the kinetic energy within 1e-6 of 3 and L^2 within 1e-6 of 0 at
   every walker, the ED energy within 1e-6 of 6.87163491; no kernel launches;
11. observables: the observables CLI (``observables.runner.cli ... --out``,
   local paths) on the stored states at batch 3360 with the float32 chain:
   ``ed_overlap`` of ``prod_r4`` (100 steps) within 0.003 of 0.99487 and of
   sector 6 against its 2Lz=12 block (``--ed-state 0``, 60 steps) within 0.01
   of 0.9599 (``BASELINE.md``), both at most 1; ``structure_factor`` of
   ``prod_r4`` (40 steps): S_0 = 6, every S_L within 0.03 of the stored
   measurement (``artifacts/prod_r4/structure_factor_n6q15.npz``), its maximum
   over L >= 1 at L = 4; ``one_rdm`` (50 steps): 16 x 16, the trace within
   0.05 of 6 and every occupation within 0.03 of 6/16; ``density`` and
   ``pair_corr`` (10 steps each): the density's mass 10 x 3360 x 6, the
   correlation hole; ``overlap`` of phase ``laughlin``'s checkpoint (5 steps)
   within 1e-4 of 1.  No kernel launches, and no synchronising call inside
   the steps (sweep, estimator, width); each run's median ms a step (CUDA
   events), its seconds and its peak memory are printed;
12. distributed: walker data parallelism (``deephall_tpu_torch/parallel``).
   ``nccl_1``: phase ``train``'s 10 KFAC iterations through the CLI in a
   one-rank NCCL group (``WORLD_SIZE=1``: every collective a real call): the
   energies equal phase ``train``'s to 1e-6 relative, the same launches, at
   most one synchronising call per block; its median iteration time beside
   phase ``train``'s, the collectives an iteration calls, by kind, and the
   host's and the card's time for one call of each at the sizes a training
   step uses (the median of 200 calls in a row).  ``gloo_2``: the same run on two ranks on ``cuda:0``
   through gloo, 1680 walkers each (child processes of this script,
   ``--rank-child``): phase ``train``'s physics gate, a checkpoint of
   (3360, 6, 2), equal parameter checksums on both ranks, every energy within
   3 standard errors of phase ``train``'s and the first equal to it to 1e-6
   relative, every launch on each rank on the tensor-core, tiled or streamed
   kernel; after its run each rank holds every kernel against its plain
   version (1e-5 relative per field, as phase ``kernels``) on the inputs that
   the local energy of its 1680 walkers of ``prod_r4`` gives it, and that
   local energy through the kernels against the plain path (1e-4 of the RMS,
   as phase ``end_to_end``); then its checkpoint resumes on one process for 2
   iterations.  ``runner_2``: ``ed_overlap`` of ``prod_r4`` over
   100 steps on two gloo ranks within 0.003 of 0.99487, saved by rank 0 alone.
   With two or more cards, ``gloo_2``'s check again through NCCL, one card a
   rank (``nccl_2``); with one card it is reported as not run;
13. trace: one block of 3 KFAC iterations of ``prod_r4`` under
   ``log.profile_dir``, then one more without the profiler, and
   ``scripts/torch_trace_summary.py`` on the trace: each hand-written
   kernel's launches in the trace equal this script's counters over the
   profiled window (3 x those of one local energy), the device's busy share
   lies in (0, 1]; the idle share, the top ten kernels, the longest gaps and
   the profiled and unprofiled iteration times are printed;
14. magnetoroton: ``scripts/magnetoroton_torch.py`` on sector Lz = 2 of
   ``prod_r4`` (``--chain 0 --iterations 20 --tail 5``, the default
   one-sided selector and its purity rail): every stage finite, with the
   launches of one local energy per iteration on the production kernels;
   one finite ``dispersion.csv`` row with the ED anchor of the Lz = 2 block
   (L^2 = 6); each stage's time and peak memory are printed;
15. tools: the measurement tools of ``scripts/`` at full width (N=6, 2Q=15,
   batch 3360, bf16 sweep).  ``torch_profile_step.py`` in both modes: every
   part's time finite and positive, the local energy launching one local
   energy's worth of every kernel a call on the tensor-core, tiled and
   streamed variants, the block of 10 ten times that.
   ``torch_capture_trace.py --l2 --blocks 1`` read by
   ``torch_trace_summary.py``: each kernel's launches in the trace 10 x one
   local energy's, the busy share in (0, 1].  ``torch_bench_jet_attention.py``:
   the kernel route within 2e-5 of the plain route (as phase ``kernels``);
   ``torch_bench_sublane_layout.py``: both layouts equal after the
   permutation.  ``torch_flops_count.py``, lean and ``--l2``, on the CPU:
   the operations and bytes of one iteration by part and class, the rate
   they give over the block-of-10 iteration time, and their least time at
   the card's peaks over that time (finite, positive, at most 1).
   ``dispersion_report_torch.py --rebuild`` on phase ``magnetoroton``'s
   directory: sector 2's row, its ED gap equal to the port's ED (1e-9), a
   finite purity;
16. large_n: systems beyond N = 6.  Every kernel of the jet (the staged
   LayerNorm with and without a residual, the whole attention, its q/k/v
   projection on the tensor cores and the streamed softmax/values kernel,
   with the heads of an item and the stages of its ring the library chose)
   against its plain version (2e-5) at B = 3360, D = 256, H = 4 and
   (N, C, E) = (8, 19, 3), (10, 21, 1), (10, 23, 3), (12, 25, 1), (12, 27, 3),
   (14, 31, 3), (16, 35, 3), with each one's time, its plain version's and its bound; the
   LayerNorm beside a plain pass over the same bytes and the generic kernel
   on the same inputs (in turns: staged, generic, generic, staged), and the
   launch counters must show that the staged and the streamed kernels took
   each launch.
   The N = 10, 2Q = 27 production state (``artifacts/prod_n10_r5``) through
   the CLI: 20 inference iterations at batch 3360, the mean energy within
   0.01 of 14.27791 (``BASELINE.md``); 5 with ``system.compute_l2=true``, L^2
   < 1 (the trained state's own L^2 is 0.55); 5 KFAC iterations resuming its curvature (step 27730 to 27735),
   finite and within 0.02; each run's launches those of its local energies on
   the staged LayerNorm and the streamed softmax/values kernel (none tiled).
   336 of its walkers
   through the kernels, the plain versions and float64 in both modes, with
   the gates of phases ``end_to_end`` and ``train``.  A fresh N = 12, 2Q = 23
   production block (seed 42, L^2 on, no checkpoint): 2 KFAC iterations,
   finite, the same launches rule, and its walkers under the same gates.
   Last, the split of an N = 10, 2Q = 27 iteration (a fresh production
   Psiformer, ``scripts/torch_profile_step.py --nelec 10 --flux 27``, both
   modes): the sweep, the local energy, the forward with its two backward
   passes, the KFAC update and the iteration in a block of 10, each finite,
   the local energy's launches on the staged LayerNorm.

The line before the last is the kernel table; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import hashlib
import importlib.util
import json
import logging
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, TOKENS, FEAT, HEADS = 3360, 6, 256, 4
MODES = ((15, 3), (13, 1))  # (C, E): L^2 mode, lean mode
KERNEL_TOL = 2e-5  # max |kernel - plain| / max |plain| per output field
END_TO_END_TOL = 1e-4
ANCHOR_ENERGY, ANCHOR_TOL = 6.8681, 0.005
ITERATIONS = 20
# After training, the kernel path against a float64 local energy: its median
# walker within this multiple of the plain float32 path's distance, and its L^2
# batch mean within the larger of a multiple of the plain path's distance and a
# share of the RMS.
MEDIAN_VS_PLAIN, L2_MEAN_VS_PLAIN, L2_MEAN_FLOOR = 1.5, 2.0, 3e-5
# The magnetoroton sector 6 (artifacts/roton13/dispersion.csv): E = 6.9719474
# +- 0.00026, Lz = 6, L^2 = 42.28, overlap 3.0e-4, resumed at step 27500.
SECTOR = REPO / "artifacts/roton13/sector_6"
SECTOR_STEP, SECTOR_ITERATIONS, SECTOR_INFERENCE = 27500, 10, 5
SECTOR_ENERGY, SECTOR_LZ, SECTOR_L2 = (6.97195, 0.005), (6.0, 0.05), (42.28, 2.0)
SECTOR_OVERLAP = 0.01
GROUND_STATE = REPO / "artifacts/prod_r4/ckpt_019999.npz"
# Training resumes prod_r4's KfacState at step 20000.
RESUME_STEP, TRAIN_ITERATIONS, ADAM_ITERATIONS = 20000, 10, 2
# After training, each batch mean through the kernels within this share of its
# standard error of the float64 batch mean.
MEAN_SHIFT_SEM = 0.05
# The analytic Laughlin state at N=6, 2Q=15 (BASELINE.md: 6.87306 +- 0.00006
# over 2000 iterations, L^2 = 0); a lowest-Landau-level state, so its local
# kinetic energy is N/2 = 3.
LAUGHLIN_ITERATIONS, LAUGHLIN_ENERGY, LAUGHLIN_TOL = 200, 6.87306, 0.001
LAUGHLIN_L2, LAUGHLIN_KINETIC, KINETIC_TOL = 0.005, 3.0, 1e-3
# The pole walkers (scripts/torch_laughlin_pole_probe.py): |KE - 3| and |L^2|.
POLE_TOL = 1e-4
# The Hessian and ED phases read the first walkers of prod_r4; the ED state's
# [walkers, 338, 6, 6] complex128 determinants go through the Hessian path in
# chunks of walkers.
HESSIAN_WALKERS, ED_CHUNK = 336, 48
ED_ENERGY, ED_TOL = 6.87163491, 1e-6
# Phase observables: (name, checkpoint, estimator, steps, extra CLI flags).
SECTOR_CKPT = SECTOR / "ckpt_027499.npz"
OBSERVABLE_RUNS = (
    ("ed_overlap", GROUND_STATE, "ed_overlap", 100, ()),
    ("ed_overlap_sector_6", SECTOR_CKPT, "ed_overlap", 60, ("--ed-state", "0")),
    ("structure_factor", GROUND_STATE, "structure_factor", 40, ()),
    ("one_rdm", GROUND_STATE, "one_rdm", 50, ()),
    ("density", GROUND_STATE, "density", 10, ()),
    ("pair_corr", GROUND_STATE, "pair_corr", 10, ()),
    ("overlap_laughlin", None, "overlap", 5, ()),  # phase laughlin's checkpoint
)
# BASELINE.md: ed_overlap 0.99487 (prod_r4, 100 steps) and 0.9599 (sector 6,
# 60 steps); the 1-RDM's occupations 0.365-0.381, around N / (2Q + 1) = 6/16.
ED_OVERLAP, ED_OVERLAP_TOL = 0.99487, 0.003
SECTOR_ED_OVERLAP, SECTOR_ED_OVERLAP_TOL = 0.9599, 0.01
STRUCTURE_FACTOR_TOL, TRACE_TOL, OCCUPATION_TOL = 0.03, 0.05, 0.03
# Phase distributed: nccl_1 against phase train per iteration (relative), gloo_2
# against it in standard errors, the iterations of the resumed 2-rank
# checkpoint, and each child process's time limit (s).
DIST_ENERGY_REL, DIST_SEM, DIST_RESUME, CHILD_TIMEOUT = 1e-6, 3.0, 2, 600
# Phase magnetoroton: scripts/magnetoroton_torch.py on one sector of prod_r4 with
# a short budget (iterations of the planned stages, tail rows).
ROTON_SECTOR, ROTON_ITERATIONS, ROTON_TAIL = 2, 20, 5
# Phase trace: prod_r4's KFAC training profiled over one block of this many
# iterations, then one more iteration without the profiler.
TRACE_ITERATIONS = 3
# Phase tools: the iterations of the block the tools time and trace.
TOOLS_BLOCK = 10
# Phase large_n: the jet's kernels at the JAX package's larger systems, (N, C,
# E) with C = 2N + E (BASELINE.md: nu = 2/5 at N = 8, nu = 1/3 at N = 10, nu
# = 3/7 at N = 12, nu = 1/5 at N = 14; N = 16 is the largest the port states
# for every kernel);
# the N = 10 production state (14.27791 +- 0.00006 over its last iterations,
# its KfacState at step 27730); and a fresh N = 12, 2Q = 23 block.  The
# trained N = 10 state is not the exact L = 0 ground state: its L^2 is 0.479
# +- 0.110 on its 3360 stored walkers in float64 and 0.555 +- 0.012 over 100
# inference iterations (scripts/torch_state_observables.py and the CLI on an
# H100; 0.12 an iteration, so 0.05 for a mean of 5).  The mean over 5
# iterations is held below 1, half of a pure L = 1 state's L(L + 1) = 2; a
# broken L^2 jet gives O(10-1000).
LARGE_N_SHAPES = ((8, 19, 3), (10, 21, 1), (10, 23, 3), (12, 25, 1), (12, 27, 3), (14, 31, 3),
                  (16, 35, 3))
N10 = REPO / "artifacts/prod_n10_r5"
N10_CKPT = N10 / "ckpt_027729.npz"
N10_ENERGY, N10_TOL, N10_KFAC_TOL, N10_L2_MAX = 14.27791, 0.01, 0.02, 1.0
N10_RESUME_STEP = 27730
N10_ITERATIONS, N10_L2_ITERATIONS, N10_KFAC_ITERATIONS = 20, 5, 5
N12_NELEC, N12_FLUX, N12_ITERATIONS = 12, 23, 2
# The parts of an N = 10 iteration that phase large_n times (torch_profile_step.py):
# the sweep, the local energy, the forward with its two backward passes, the
# KFAC update, and the iteration in a block of 10.
SPLIT_PARTS = ("sweep", "local_energy", "gradient_capture", "kfac_update", "block")
# The numbers of each kernel row that phase large_n's line repeats.
LARGE_N_FIELDS = ("ms", "plain_ms", "bound_ms", "max_rel_err", "generic_ms", "same_bytes_add_ms",
                  "no_residual_ms", "no_residual_plain_ms", "no_residual_bound_ms",
                  "no_residual_max_rel_err", "no_residual_generic_ms",
                  "no_residual_same_bytes_add_ms")
# The jet LayerNorm takes under half a millisecond, and the host's work before
# its launch an eighth to a sixth of that (measured on an H100 host): it is
# timed over this many calls in a row.
LN_CALLS = 5

# Memory rate (bytes/s), float32 CUDA-core rate and dense TF32 tensor-core rate
# (flop/s) by card, from NVIDIA's data sheets; the first match in the device
# name wins.
PEAKS = (
    ("H100 PCIe", 2.0e12, 51e12, 378e12),
    ("H100 NVL", 3.9e12, 60e12, 417e12),
    ("H200", 4.8e12, 67e12, 495e12),
    ("H100", 3.35e12, 67e12, 495e12),
)


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def script_module(name: str):
    """``scripts/<name>.py`` imported by its path (``scripts`` is no package)."""
    spec = importlib.util.spec_from_file_location(name, REPO / "scripts" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def peaks(name: str) -> tuple[float, float, float]:
    for key, *rates in PEAKS:
        if key in name:
            return tuple(rates)
    raise RuntimeError(f"no peak rates known for {name}")


def bound(nbytes: float, flops: float, rates, product_flops: float = 0.0) -> tuple[float, str]:
    """Least time in ms: bytes at the memory rate, or ``flops`` at the float32
    rate plus ``product_flops`` as three TF32 products each on the tensor cores."""
    t_bytes = nbytes / rates[0] * 1e3
    t_ops = (flops / rates[1] + 3 * product_flops / rates[2]) * 1e3
    if t_bytes >= t_ops:
        return t_bytes, "bytes"
    return t_ops, "operations (3xTF32)" if product_flops else "operations"


def against(row: dict) -> dict:
    """``row`` with the kernel's time over the library's and its bound over its time."""
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    if row.get("library_ms"):
        row["vs_library"] = row["ms"] / row["library_ms"]
    return row


def cuda_ms(fn, reps: int = 10, warmup: int = 2, calls: int = 1) -> float:
    """Median of CUDA-event timings of ``fn`` after warm-up, in ms.

    With ``calls`` above 1 each timing spans that many calls in a row and is
    divided by it, so that the host's work before a launch (the events wait
    through it while the card idles) hides under the call before.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def field_error(got, want) -> tuple[float, float]:
    """(max abs error, max abs error / max abs value) over one output field."""
    err = (got - want).abs().max().item()
    return err, err / max(want.abs().max().item(), 1e-30)


def compare(name: str, got, want, tol: float) -> dict:
    """Worst absolute and relative error over the fields; raises beyond ``tol``."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst_abs, worst_rel = 0.0, 0.0
    for a, b in zip(got, want):
        err, rel = field_error(a, b)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
    if not worst_rel <= tol:
        raise AssertionError(f"{name}: relative error {worst_rel:.3e} > {tol:.0e}")
    return dict(max_abs_err=worst_abs, max_rel_err=worst_rel)


def random_jet(gen, c, e, device, batch=BATCH, tokens=TOKENS):
    from deephall_tpu_torch.ops.fwdlap import Jet

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    s = (batch, tokens, FEAT)
    return Jet(normal(*s), normal(c, *s), normal(*s), normal(e, *s))


def attention_params(gen, device):
    """Weights scaled as the JAX package's jet-attention test does."""
    dh = FEAT // HEADS

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {
        name: {
            "kernel": normal(FEAT, HEADS, dh, scale=1 / math.sqrt(FEAT)),
            "bias": normal(HEADS, dh, scale=0.1),
        }
        for name in ("query", "key", "value")
    }
    p["out"] = {
        "kernel": normal(HEADS, dh, FEAT, scale=1 / math.sqrt(FEAT)),
        "bias": normal(FEAT, scale=0.1),
    }
    return p


def same_bytes_add_ms(planes: int, device, batch: int, tokens: int, residual: bool = True) -> float:
    """Time of ``torch.add(T, R, out=O)`` on three buffers of a jet's size (with
    ``residual`` false ``torch.add(T, 1, out=O)``: one read and one write)."""
    t, r, out = (torch.empty(planes, batch, tokens, FEAT, device=device).fill_(i) for i in range(3))
    if not residual:
        return cuda_ms(lambda: torch.add(t, 1.0, out=out), calls=LN_CALLS)
    return cuda_ms(lambda: torch.add(t, r, out=out), calls=LN_CALLS)


def layernorm_rows(device, rates, gen, c: int, e: int, t, r, production: bool) -> dict:
    """The jet LayerNorm against its plain version on one jet shape, with a
    residual (the streamed kernel at the production shapes, the staged one
    elsewhere) and without (the staged one), each with its time, its plain
    version's, its bound and a plain pass over the same bytes; where the
    staged kernel runs, the generic kernel on the same inputs, timed in turns
    (staged, generic, generic, staged).  Raises unless the routing rule's
    kernel took each launch."""
    from deephall_tpu_torch.ops import jet_layernorm as jl

    fn = jl.layernorm_jet
    batch, tokens = t.x.shape[:2]
    planes = c + e + 2
    elems = planes * batch * tokens * FEAT
    shape = f"T={tokens} (C, E)=({c}, {e})"
    p_ln = {
        "scale": torch.randn(FEAT, generator=gen, device=device) * 0.3 + 1.0,
        "bias": torch.randn(FEAT, generator=gen, device=device) * 0.1,
    }
    row = {}
    for residual in (r, None):
        kernel = "streamed" if production and residual is not None else "staged"
        what = f"jet_layernorm {shape}" + ("" if residual is not None else " without a residual")
        before = fn.launches_streamed, fn.launches_staged
        err = compare(what, tuple(fn(p_ln, t, residual=residual)),
                      tuple(jl.layernorm_jet_plain(p_ln, t, residual=residual)), KERNEL_TOL)
        took = (fn.launches_streamed - before[0], fn.launches_staged - before[1])
        if took != ((1, 0) if kernel == "streamed" else (0, 1)):
            raise AssertionError(f"{what}: not the {kernel} kernel")
        # Read the jet (and the residual), write the output; about a dozen
        # flops per element (add, centre, variance products, output expansion).
        reads = 2 if residual is not None else 1
        ln_bound = bound((reads + 1) * elems * 4 + 2 * FEAT * 4, 12 * elems, rates)
        numbers = dict(
            variant=kernel, **err,
            plain_ms=cuda_ms(lambda: jl.layernorm_jet_plain(p_ln, t, residual=residual), reps=5),
            bound_ms=ln_bound[0], bound_by=ln_bound[1], library_ms=None,
            # What the card gives a plain pass over the same bytes.
            same_bytes_add_ms=same_bytes_add_ms(planes, device, batch, tokens, residual is not None),
        )
        routed = lambda: fn(p_ln, t, residual=residual)  # noqa: E731
        if kernel == "staged":
            generic = lambda: jl.layernorm_jet_generic(p_ln, t, residual=residual)  # noqa: E731
            generic_err = compare(f"{what}, generic kernel", tuple(generic()),
                                  tuple(jl.layernorm_jet_plain(p_ln, t, residual=residual)), KERNEL_TOL)
            turns = [cuda_ms(f, calls=LN_CALLS) for f in (routed, generic, generic, routed)]
            numbers.update(ms=(turns[0] + turns[3]) / 2, generic_ms=(turns[1] + turns[2]) / 2,
                           turns_ms=turns, generic_max_rel_err=generic_err["max_rel_err"])
        else:
            numbers.update(ms=cuda_ms(routed, calls=LN_CALLS))
        numbers["single_call_ms"] = cuda_ms(routed)
        if residual is not None:
            row.update(numbers)
        else:
            row.update({f"no_residual_{k}": v for k, v in numbers.items()})
    return against(row)


def kernel_rows(device, rates, c: int, e: int, tokens: int = TOKENS, batch: int = BATCH) -> dict:
    """Each kernel against its plain version on random inputs of one jet shape,
    with its time, its plain version's and its bound: the jet LayerNorm
    (:func:`layernorm_rows`), the whole attention, its two projections on the
    tensor cores, and the softmax/values core (tiled at the production shapes,
    streamed elsewhere, with the library's plan for the streamed kernel)."""
    from deephall_tpu_torch.ops import jet_attention as ja

    production = tokens == TOKENS and (c, e) in MODES
    gen = torch.Generator(device=device).manual_seed(1000 * tokens + c)
    planes = c + e + 2
    rows = batch * tokens
    elems = planes * rows * FEAT
    shape = f"T={tokens} (C, E)=({c}, {e})"
    results = {}

    t = random_jet(gen, c, e, device, batch, tokens)
    r = random_jet(gen, c, e, device, batch, tokens)
    results["jet_layernorm"] = layernorm_rows(device, rates, gen, c, e, t, r, production)
    del r

    p = attention_params(gen, device)
    att_bytes, core_flops, proj_flops = ja.attention_work(batch, tokens, FEAT, HEADS, c, e)
    err = compare(
        f"jet_attention {shape}",
        tuple(ja.attention_jet(p, HEADS, t)),
        tuple(ja.attention_jet_plain(p, HEADS, t)),
        KERNEL_TOL,
    )
    att_bound = bound(att_bytes, core_flops, rates, proj_flops)
    results["jet_attention"] = against(dict(
        **err,
        ms=cuda_ms(lambda: ja.attention_jet(p, HEADS, t)),
        plain_ms=cuda_ms(lambda: ja.attention_jet_plain(p, HEADS, t), reps=5),
        bound_ms=att_bound[0], bound_by=att_bound[1], library_ms=None,
    ))

    stacked = torch.cat([t.x[None], t.j, t.l[None], t.d]).reshape(planes * rows, FEAT)
    del t
    m = planes * rows
    for width, key in ((3 * FEAT, "jet_gemm"), (FEAT, "jet_gemm_out")):
        w = torch.randn(FEAT, width, generator=gen, device=device) / math.sqrt(FEAT)
        b = torch.randn(width, generator=gen, device=device) * 0.1
        split = ja.split_weight(w)
        before = ja.jet_gemm.launches_tensor_core
        out = ja.jet_gemm(stacked, split, b, rows)
        if ja.jet_gemm.launches_tensor_core != before + 1:
            raise AssertionError(f"jet_gemm {shape} N={width}: not on the tensor cores")
        err = compare(f"jet_gemm {shape} N={width}", out, ja.jet_gemm_plain(stacked, w, b, rows), KERNEL_TOL)
        gemm_bound = bound((m * FEAT + FEAT * width + width + m * width) * 4, 0,
                           rates, 2 * m * FEAT * width)
        results[key] = against(dict(
            **err,
            ms=cuda_ms(lambda: ja.jet_gemm(stacked, split, b, rows)),
            plain_ms=cuda_ms(lambda: ja.jet_gemm_plain(stacked, w, b, rows)),
            bound_ms=gemm_bound[0], bound_by=gemm_bound[1],
            library_ms=cuda_ms(lambda: torch.matmul(stacked, w)),
            cuda_core_ms=cuda_ms(lambda: ja.jet_gemm(stacked, w, b, rows), reps=3),
        ))
        if width == 3 * FEAT:
            qkv = out
        del out
    del stacked

    before = ja.softmax_values.launches_tiled
    err = compare(
        f"jet_softmax_values {shape}",
        ja.softmax_values(qkv, batch, tokens, HEADS, c, e),
        ja.softmax_values_plain(qkv, batch, tokens, HEADS, c, e),
        KERNEL_TOL,
    )
    if ja.softmax_values.launches_tiled != before + production:
        raise AssertionError(
            f"jet_softmax_values {shape}: not the {'tiled' if production else 'streamed'} kernel")
    sv_bound = bound(4 * elems * 4, core_flops, rates)
    plan = {} if production else dict(zip(("group", "stages", "threads"),
                                            ja.streamed_plan(device, tokens, FEAT, HEADS)))
    results["jet_softmax_values"] = against(dict(
        **err, **plan,
        ms=cuda_ms(lambda: ja.softmax_values(qkv, batch, tokens, HEADS, c, e)),
        plain_ms=cuda_ms(lambda: ja.softmax_values_plain(qkv, batch, tokens, HEADS, c, e), reps=5),
        bound_ms=sv_bound[0], bound_by=sv_bound[1], library_ms=None,
    ))
    del qkv
    torch.cuda.empty_cache()
    return results


def phase_kernels(device, rates) -> dict:
    """Each kernel against its plain version at production shapes, both modes."""
    results = {}
    for c, e in MODES:
        mode = f"C{c}E{e}"
        for name, row in kernel_rows(device, rates, c, e).items():
            results[(name, mode)] = row
            emit(phase="kernel", kernel=name, mode=mode, **row)
    return results


# Phase orbital_head: (name, N, 2Q, determinants, E) of the benchmark's
# configurations and jet modes, at batch 3360 and D = 256; at N = 14, 2Q = 65
# the 66 harmonics take two harmonic-range passes, each also timed alone.
ORBITAL_SHAPES = (("N6C15E3", 6, 15, 1, 3), ("N6C13E1", 6, 15, 1, 1),
                  ("N10C21E1", 10, 27, 1, 1), ("N10C21E1K16", 10, 27, 16, 1),
                  ("N14C31E3", 14, 65, 1, 3), ("N14C29E1", 14, 65, 1, 1))


def orbital_head_rows(device, rates, nelec: int, flux: int, ndet: int, e: int) -> dict:
    """The orbital head's kernel against its plain version on random inputs of
    one shape (the tower jet, the envelope's jet at random walkers, the head's
    weights), with its time, the plain version's and its bound."""
    from deephall_tpu_torch.networks import fwdlap as network_jet
    from deephall_tpu_torch.ops import fwdlap
    from deephall_tpu_torch.ops import orbital_head as oh
    from deephall_tpu_torch.ops.fwdlap import Jet

    gen = torch.Generator(device=device).manual_seed(100 * nelec + ndet + e)
    c, harmonics, pairs = 2 * nelec + e, flux + 1, nelec * ndet
    planes = c + e + 2

    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    h = Jet(normal(BATCH, nelec, FEAT), normal(c, BATCH, nelec, FEAT),
            normal(BATCH, nelec, FEAT), normal(e, BATCH, nelec, FEAT))
    theta = torch.acos(2 * torch.rand(BATCH, nelec, generator=gen, device=device) - 1)
    phi = 2 * math.pi * torch.rand(BATCH, nelec, generator=gen, device=device)
    data = torch.stack([theta, phi], dim=-1)
    env = fwdlap.jet_of_fn(network_jet.envelope_fn(flux), data,
                           fwdlap.electron_seeds(data, e == 3), e)
    p = {f"DenseGeneral_{i}": {"kernel": normal(FEAT, harmonics, nelec, ndet, scale=FEAT**-0.5),
                               "bias": normal(harmonics, nelec, ndet, scale=0.1)}
         for i in range(2)}
    spins = (nelec, 0)
    before = oh.orbital_matrices_jet.launches
    got = oh.orbital_matrices_jet(p, h, env, spins)
    if oh.orbital_matrices_jet.launches != before + 1:
        raise AssertionError(f"orbital_head {nelec, ndet, e}: the kernel did not launch")
    err = compare(f"orbital_head {nelec, ndet, e}", tuple(got),
                  tuple(oh.orbital_matrices_plain(p, h, env, spins)), KERNEL_TOL)
    del got
    rows = planes * BATCH * nelec
    product_flops = 2 * rows * FEAT * 2 * harmonics * pairs
    contraction_flops = 8 * harmonics * BATCH * nelec * pairs * (planes + oh.side_planes(e))
    nbytes = (rows * FEAT * 4 + (c + e + 2) * BATCH * nelec * harmonics * 8
              + planes * BATCH * pairs * nelec * 8)
    least = bound(nbytes, contraction_flops, rates, product_flops)
    ranges = oh.harmonic_ranges(harmonics)
    passes = []
    for f0, f1 in ranges:  # each pass alone: one launch on the range's head and envelope
        part = {k: oh.harmonic_slice(v, f0, f1) for k, v in p.items()}
        part_env = Jet(*(v[..., f0:f1].contiguous() for v in env))
        passes.append(dict(harmonics=[f0, f1], plan=oh.column_plan(f1 - f0, pairs)._asdict(),
                           ms=cuda_ms(lambda part=part, part_env=part_env: oh.orbital_matrices_jet(
                               part, h, part_env, spins))))
        del part_env
    row = against(dict(
        **err, plan=passes[0]["plan"], passes=passes if len(ranges) > 1 else None,
        ms=cuda_ms(lambda: oh.orbital_matrices_jet(p, h, env, spins)),
        plain_ms=cuda_ms(lambda: oh.orbital_matrices_plain(p, h, env, spins), reps=3),
        bound_ms=least[0], bound_by=least[1],
    ))
    torch.cuda.empty_cache()
    return row


def phase_orbital_head(device, rates) -> dict:
    """The orbital head's kernel at the benchmark's four configurations: its
    rows, keyed by shape."""
    results = {}
    for name, nelec, flux, ndet, e in ORBITAL_SHAPES:
        results[name] = orbital_head_rows(device, rates, nelec, flux, ndet, e)
        emit(phase="orbital_head", shape=name, **results[name])
    return results


# Phase kfac_gram: (name, rows, columns, ones column) of KFAC's factors: the
# 16-determinant head's G at N = 10 and an N = 6 layer's A with its bias.
GRAM_SHAPES = (("G_K16_N10", 33600, 4480, False), ("A_bias_N6", 20160, 256, True))


def kfac_gram_rows(device, rates, rows: int, cols: int, ones: bool) -> dict:
    """KFAC's Gram-product kernel against its plain version (``torch.matmul``
    in float32) and float64 on random inputs of one shape, with its time, the
    plain version's, ``torch.matmul``'s alone and its bound."""
    from deephall_tpu_torch.ops import kfac_gram as kg

    name = f"kfac_gram {rows, cols, ones}"
    gen = torch.Generator(device=device).manual_seed(rows + cols)
    x = torch.randn(rows, cols, generator=gen, device=device) + 0.5
    before = kg.gram.launches
    got = kg.gram(x, ones)
    if kg.gram.launches != before + 1:
        raise AssertionError(f"{name}: the kernel did not launch")
    if not torch.equal(got, got.T):
        raise AssertionError(f"{name}: not exactly symmetric")
    plain = kg.gram_plain(x, ones)
    err = compare(name, got, plain, KERNEL_TOL)
    exact = kg.gram_plain(x.double(), ones)

    def frobenius(v):
        return float(torch.linalg.norm(v.double() - exact) / torch.linalg.norm(exact))

    err.update(frobenius_err=frobenius(got), plain_frobenius_err=frobenius(plain))
    if not err["frobenius_err"] <= 2 * err["plain_frobenius_err"]:
        raise AssertionError(f"{name}: farther from float64 than twice the plain version: {err}")
    del got, plain, exact
    n = cols + int(ones)
    full = torch.cat([x, torch.ones((rows, 1), device=device)], -1) if ones else x
    # The triangle's products; the ones column's sums are additions.
    least = bound(rows * cols * 4 + n * n * 4, rows * cols * int(ones), rates,
                  product_flops=rows * cols * (cols + 1))
    row = against(dict(
        **err, plan=kg.plan(rows, cols, torch.cuda.get_device_properties(device).multi_processor_count)._asdict(),
        ms=cuda_ms(lambda: kg.gram(x, ones)),
        plain_ms=cuda_ms(lambda: kg.gram_plain(x, ones)),
        library_ms=cuda_ms(lambda: torch.matmul(full.T, full)),
        bound_ms=least[0], bound_by=least[1],
    ))
    torch.cuda.empty_cache()
    return row


def phase_kfac_gram(device, rates) -> dict:
    """KFAC's Gram-product kernel at :data:`GRAM_SHAPES`: its rows, keyed by shape."""
    results = {}
    for name, rows, cols, ones in GRAM_SHAPES:
        results[name] = kfac_gram_rows(device, rates, rows, cols, ones)
        emit(phase="kfac_gram", shape=name, **results[name])
    return results


def table_numbers(row: dict) -> dict:
    """``row`` for the kernel table: ``bound_by`` is ``bytes`` or ``operations`` there,
    and which operations (three TF32 products) goes to ``bound_detail``."""
    kind = row["bound_by"].split(" ")[0]
    return {**row, "bound_by": kind, "bound_detail": row["bound_by"]}


def spills(lines: list[str], kernel: str) -> list[str]:
    """Each instantiation of ``kernel`` in ptxas's lines (``-Xptxas=-v``) with its
    spill line unless that says 0 bytes; raises if there is no instantiation."""
    entries = [i for i, line in enumerate(lines) if "Compiling entry" in line and kernel in line]
    if not entries:
        raise AssertionError(f"build: no {kernel} in ptxas's output")
    bad = []
    for i in entries:
        spill = next((line for line in lines[i + 1:] if "spill" in line), "")
        if "0 bytes spill stores, 0 bytes spill loads" not in spill:
            bad.append(f"{lines[i]}: {spill or 'no spill line'}")
    return bad


def launch_counts() -> dict:
    from deephall_tpu_torch.ops import launch_counts as counts

    return counts()


def reset_counts() -> None:
    from deephall_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def phase_slice(workdir: Path) -> dict:
    """Inference of the converged N=6 state through the CLI, at batch 3360."""
    from deephall_tpu_torch import train

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    history = train.cli([
        "--yml", str(REPO / "artifacts/prod_r4/config.yml"),
        "optim.optimizer=none",
        f"log.restore_path={REPO / 'artifacts/prod_r4/ckpt_019999.npz'}",
        f"log.save_path={workdir}",
        f"optim.iterations={ITERATIONS}",
        "mcmc.burn_in=10",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = launch_counts()

    energies = np.array([row["energy"].real for row in history])
    l_square = np.array([row["angular_momentum_square"] for row in history])
    step_times = [row["step_time"] for row in history]
    calls = ITERATIONS + 1  # the iterations and the initial-energy probe
    expected = {k: calls * v for k, v in launches_per_local_energy().items()}
    result = dict(
        iterations=len(history),
        mean_energy=float(energies.mean()),
        energy_sem=float(energies.std(ddof=1) / math.sqrt(len(energies))),
        mean_l_square=float(l_square.mean()),
        mean_variance=float(np.mean([row["variance"] for row in history])),
        mean_pmove=float(np.mean([row["pmove"] for row in history])),
        step_time_median_s=statistics.median(step_times),
        step_times_s=step_times,
        wall_s=wall,
        peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts,
        expected_launches=expected,
    )
    emit(phase="slice", **result)
    if len(history) != ITERATIONS or np.isnan(energies).any():
        raise AssertionError("slice: missing iterations or NaN energy")
    if abs(result["mean_energy"] - ANCHOR_ENERGY) > ANCHOR_TOL:
        raise AssertionError(f"slice: mean energy {result['mean_energy']} not within {ANCHOR_TOL} of {ANCHOR_ENERGY}")
    if not result["mean_l_square"] < 0.2:
        raise AssertionError(f"slice: mean L^2 {result['mean_l_square']} >= 0.2")
    if counts != expected:
        raise AssertionError(f"slice: launch counts {counts} != expected {expected}")
    return counts


def path_agreement(model, system, data) -> tuple[dict, list]:
    """Observables of ``data`` through the kernels against the plain versions.

    A walker near a node or a pole amplifies float32 rounding in its second
    derivatives by the conditioning of its orbital matrix, on either path, so
    single walkers may differ by far more than the kernels do (measured on the
    H100: one walker's L^2 of ~16 moved by 0.25).  The gate therefore reads the
    batch: the shift of the batch mean and the median per-walker deviation,
    each relative to the observable's RMS over the walkers.
    """
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    out = {}
    with torch.no_grad():
        for kernels in (True, False):
            el, obs = forward_laplacian_local_energy(model, system, kernels=kernels)(data)
            out[kernels] = {"energy": el, **obs}
    report = {}
    for key, got in out[True].items():
        want = out[False][key]
        got, want = got.real.double(), want.real.double()
        rms = want.square().mean().sqrt().item()
        dev = (got - want).abs()
        report[key] = dict(
            mean_kernel=got.mean().item(), mean_plain=want.mean().item(), rms=rms,
            mean_shift_rel=abs(got.mean().item() - want.mean().item()) / rms,
            median_dev_rel=dev.median().item() / rms,
            p99_dev_rel=dev.quantile(0.99).item() / rms,
            max_abs_err=dev.max().item(),
        )
    bad = [
        k for k, v in report.items()
        if not (v["mean_shift_rel"] <= END_TO_END_TOL and v["median_dev_rel"] <= END_TO_END_TOL)
    ]
    return report, bad


def restored_model(ckpt: Path, device, config: Path = REPO / "artifacts/prod_r4/config.yml"):
    """The configuration (prod_r4's unless ``config`` names another) and a model
    on ``device`` with ``ckpt``'s parameters."""
    import yaml

    from deephall_tpu_torch.config import Config
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.weights import load_flax

    cfg = Config.from_dict(yaml.safe_load(config.read_text()))
    _, state, _ = LogManager.restore_checkpoint(ckpt)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, state.params)
    return cfg, model.to(device), state


def phase_end_to_end(device) -> None:
    """Observables of the stored walkers through the kernels and the plain versions."""
    from deephall_tpu_torch import mcmc, train
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    cfg, model, state = restored_model(REPO / "artifacts/prod_r4/ckpt_019999.npz", device)
    model.requires_grad_(False)
    data = torch.as_tensor(state.data, device=device)
    report, bad = path_agreement(model, cfg.system, data)
    local_energy = {
        kernels: forward_laplacian_local_energy(model, cfg.system, kernels=kernels)
        for kernels in (True, False)
    }
    sweep = mcmc.make_mcmc_step(lambda x: model(x, train.sweep_dtype()), steps=cfg.mcmc.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    timing = {}
    with torch.no_grad():
        # Where an iteration's time goes: the local energy on each path, and
        # one sweep of cfg.mcmc.steps moves.
        timing["local_energy_kernels_ms"] = cuda_ms(lambda: local_energy[True](data), reps=5)
        timing["local_energy_plain_ms"] = cuda_ms(lambda: local_energy[False](data), reps=5)
        timing["sweep_ms"] = cuda_ms(lambda: sweep(data, float(state.mcmc_width), gen), reps=5)
    emit(phase="end_to_end", walkers=int(data.shape[0]), tolerance=END_TO_END_TOL,
         fields=report, **timing)
    if bad:
        raise AssertionError(f"end_to_end: {bad} differ by more than {END_TO_END_TOL}")


def phase_psiformer_pole(device) -> dict:
    """The Psiformer's jet local energy with an electron at or near a pole.

    The walkers of ``scripts/torch_psiformer_pole_probe.py:pole_walkers``
    (``prod_r4``'s stored walkers with electron 0 at float32 pi, pi - 3.45e-4,
    pi - 1e-3, pi - 1e-2 twice, 3.45e-4, 1e-3, 1e-2 and 0, then 8 ordinary
    ones) through the kernels in float32, against the plain route with the
    model and walkers in float64, both on the card: every pole walker finite
    and within the probe's ``GATE``, and one local energy's launches.
    """
    probe = script_module("torch_psiformer_pole_probe")
    cfg, model, stored = probe.prod_r4()
    model = model.to(device)
    data = torch.from_numpy(probe.pole_walkers(stored)).to(device)
    reset_counts()
    f32 = probe.evaluate(model, cfg.system, data, kernels=True)
    counts = launch_counts()
    f64 = probe.evaluate(copy.deepcopy(model).double(), cfg.system, data.double(), kernels=False)
    for i in range(len(probe.POLE_THETA)):
        print(f"psiformer_pole: theta_0 {data[i, 0, 0].item():.8f} kinetic {f32['kinetic'][i]:.6f} "
              f"({f64['kinetic'][i]:.6f} float64) L^2 {f32['angular_momentum_square'][i]:.6f} "
              f"({f64['angular_momentum_square'][i]:.6f} float64)", flush=True)
    failures = probe.gate_failures(f32, f64)
    expected = launches_per_local_energy(cfg.network.psiformer.num_layers)
    emit(phase="psiformer_pole", theta=data[:, 0, 0].tolist(), gate=probe.GATE,
         float32={k: v.tolist() for k, v in f32.items()},
         float64={k: v.tolist() for k, v in f64.items()},
         launches=counts, expected_launches=expected, failures=failures)
    if failures:
        raise AssertionError(f"psiformer_pole: pole walkers outside the gate: {failures}")
    if counts != expected:
        raise AssertionError(f"psiformer_pole: launch counts {counts} != expected {expected}")
    return counts


class WarningLog(logging.Filter):
    """Keeps the messages of the ``deephall`` logger's warnings (a filter on
    the logger survives ``init_logging``, which replaces its handlers)."""

    def __init__(self):
        super().__init__()
        self.messages: list[str] = []

    def filter(self, record):
        if record.levelno >= logging.WARNING:
            self.messages.append(record.getMessage())
        return True


def prod_r4_argv(workdir: Path, optimizer: str, iterations: int) -> list[str]:
    return [
        "--yml", str(REPO / "artifacts/prod_r4/config.yml"),
        f"optim.optimizer={optimizer}",
        f"log.restore_path={REPO / 'artifacts/prod_r4/ckpt_019999.npz'}",
        f"log.save_path={workdir}",
        f"optim.iterations={RESUME_STEP + iterations}",
    ]


def train_cli(workdir: Path, optimizer: str, iterations: int, *extra: str) -> tuple[list, list]:
    """The training CLI resuming ``prod_r4``; returns its history and its warnings."""
    from deephall_tpu_torch import train

    log = WarningLog()
    logger = logging.getLogger("deephall")
    logger.addFilter(log)
    try:
        history = train.cli([*prod_r4_argv(workdir, optimizer, iterations), *extra])
    finally:
        logger.removeFilter(log)
    torch.cuda.synchronize()
    return history, log.messages


def relative_l2(got: dict, want: dict) -> float:
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    return math.sqrt(num / den)


def training_paths(model, stale_model, system, data) -> dict:
    """``{path: {observable: per-walker values}}`` for the kernels, the plain
    versions, the plain versions in float64 and, unless ``stale_model`` is
    None, the plain versions with its weights."""
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    routes = [("kernels", model, True, data), ("plain", model, False, data),
              ("float64", copy.deepcopy(model).double(), False, data.double())]
    if stale_model is not None:
        routes.append(("stale", stale_model, False, data))
    out = {}
    with torch.no_grad():
        for name, net, kernels, x in routes:
            el, obs = forward_laplacian_local_energy(net, system, kernels=kernels)(x)
            out[name] = {"energy": el, **obs}
    return out


def training_agreement(paths: dict) -> dict:
    """Per observable: the kernel path against the plain path (relative to the
    RMS), each float32 path's batch-mean error against float64 (relative to the
    batch mean's standard error) and the stale weights' median deviation.

    A walker near a node amplifies float32 rounding on either path, and in a
    batch mean one such walker can move the two float32 paths apart by more
    than 1e-4 of the RMS while both stay far inside the mean's statistical
    error; float64 says which path is off and by how much.
    """
    report = {}
    for key in paths["float64"]:
        vals = {name: v[key].real.double() for name, v in paths.items()}
        truth = vals["float64"]
        rms = truth.square().mean().sqrt().item()
        sem = truth.std().item() / math.sqrt(truth.numel())
        mean = {name: v.mean().item() for name, v in vals.items()}
        report[key] = dict(
            rms=rms, sem=sem,
            kernels_vs_plain_mean_shift_rel=abs(mean["kernels"] - mean["plain"]) / rms,
            kernels_vs_plain_median_dev_rel=(vals["kernels"] - vals["plain"]).abs().median().item() / rms,
            kernels_vs_float64_mean_shift_sem=abs(mean["kernels"] - mean["float64"]) / max(sem, 1e-30),
            plain_vs_float64_mean_shift_sem=abs(mean["plain"] - mean["float64"]) / max(sem, 1e-30),
            **{f"{name}_vs_float64_median_dev_rel": (vals[name] - truth).abs().median().item() / rms
               for name in ("kernels", "plain")},
            **{f"{name}_vs_float64_mean_shift_rel": abs(mean[name] - mean["float64"]) / rms
               for name in ("kernels", "plain")},
        )
        if "stale" in vals:
            report[key]["stale_vs_plain_median_dev_rel"] = (
                (vals["stale"] - vals["plain"]).abs().median().item() / rms)
    return report


def float64_gate(fields: dict) -> list[str]:
    """The observables in which the kernel path is farther from float64 than
    the plain float32 path allows: the median walker beyond MEDIAN_VS_PLAIN
    times the plain path's distance, or the L^2 batch mean beyond the larger
    of L2_MEAN_VS_PLAIN times the plain path's distance and L2_MEAN_FLOOR of
    the RMS."""
    bad = [k for k, v in fields.items()
           if not v["kernels_vs_float64_median_dev_rel"]
           <= MEDIAN_VS_PLAIN * v["plain_vs_float64_median_dev_rel"]]
    l2 = fields["angular_momentum_square"]
    if not l2["kernels_vs_float64_mean_shift_rel"] <= max(
            L2_MEAN_VS_PLAIN * l2["plain_vs_float64_mean_shift_rel"], L2_MEAN_FLOOR):
        bad.append("angular_momentum_square batch mean")
    return bad


def kfac_step_updates(cfg, model, data, opt_state, paths: dict) -> dict:
    """One KFAC step from the same state with the local energy of the kernel,
    plain and float64 paths: relative L2 distances between the updates."""
    from deephall_tpu_torch import loss
    from deephall_tpu_torch.optimizers import kfac

    params = dict(model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    specs = kfac.discover(model, sum(cfg.system.nspins))
    updates = {}
    for name in ("kernels", "plain", "float64"):
        obs = {k: v.to(torch.complex64 if v.is_complex() else torch.float32)
               for k, v in paths[name].items()}
        el = obs.pop("energy")
        _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, data, el, obs)
        kfac.kfac_update(cfg.optim.kfac, specs, params, opt_state, grads, inputs, dy)
        updates[name] = {k: p.detach() - saved[k] for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])
    return {f"{a}_vs_{b}": relative_l2(updates[a], updates[b])
            for a, b in (("kernels", "plain"), ("kernels", "float64"), ("plain", "float64"))}


def phase_train(workdir: Path, device) -> dict:
    """KFAC training resuming the converged N=6 state through the CLI, at batch 3360."""
    from deephall_tpu_torch import loss, mcmc, optimizers, train
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.optimizers import kfac
    from deephall_tpu_torch.types import AdamState, KfacState
    from deephall_tpu_torch.weights import flatten

    artifact = REPO / "artifacts/prod_r4/ckpt_019999.npz"
    _, start, _ = LogManager.restore_checkpoint(artifact)
    if not isinstance(start.opt_state, KfacState) or int(start.opt_state.step) != RESUME_STEP:
        raise AssertionError("train: the stored KfacState did not load")

    from deephall_tpu_torch.ops import kfac_gram

    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    wall = time.perf_counter()
    gram_launches = kfac_gram.gram.launches
    history, warnings = train_cli(workdir / "kfac", "kfac", TRAIN_ITERATIONS)
    wall = time.perf_counter() - wall
    counts = launch_counts()
    gram_launches = kfac_gram.gram.launches - gram_launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    last = workdir / "kfac" / f"ckpt_{RESUME_STEP + TRAIN_ITERATIONS - 1:06d}.npz"
    cfg, model, final = restored_model(last, device)
    expected = {k: TRAIN_ITERATIONS * v
                for k, v in launches_per_local_energy(cfg.network.psiformer.num_layers).items()}
    energies = np.array([row["energy"].real for row in history])
    l_square = np.array([row["angular_momentum_square"] for row in history])
    # lr^2 coeff^2 d^T F d: the step's quadratic norm, held to the constraint.
    step_norms = [row["learning_rate"] ** 2 * row["norm_coefficient"] ** 2 * row["quadratic_norm"]
                  for row in history]
    before, after = flatten(start.params), flatten(final.params)
    moved = math.sqrt(sum(float(np.square(after[k] - before[k]).sum()) for k in before)
                      / sum(float(np.square(before[k]).sum()) for k in before))

    # On the trained walkers: the local energy through the kernels, through the
    # plain versions, through the plain versions in float64 (the reference) and
    # through the plain versions with the weights from before training.
    data = torch.as_tensor(final.data, device=device)
    params = dict(model.named_parameters())
    opt_state = optimizers.state_to(final.opt_state, device)
    paths = training_paths(model, restored_model(artifact, device)[1], cfg.system, data)
    fields = training_agreement(paths)
    # One KFAC step from the final state with each path's local energy.
    updates = kfac_step_updates(cfg, model, data, opt_state, paths)

    local_energy = forward_laplacian_local_energy(model, cfg.system)
    sweep = mcmc.make_mcmc_step(lambda x: model(x, train.sweep_dtype()), steps=cfg.mcmc.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        el, obs = local_energy(data)
    _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, data, el, obs)
    specs = kfac.discover(model, sum(cfg.system.nspins))
    # Each update forms both factors of every Kronecker block by the kernel.
    gram_expected = TRAIN_ITERATIONS * 2 * sum(spec.kind == "kron" for spec in specs)

    def kfac_update():
        kfac.kfac_update(cfg.optim.kfac, specs, params, opt_state, grads, inputs, dy)

    saved = {k: p.detach().clone() for k, p in params.items()}

    with torch.no_grad():
        split = dict(
            sweep_ms=cuda_ms(lambda: sweep(data, float(final.mcmc_width), gen), reps=5),
            local_energy_ms=cuda_ms(lambda: local_energy(data), reps=5),
        )
    split["forward_and_two_backward_ms"] = cuda_ms(
        lambda: loss.gradient_and_capture(model, cfg.system, data, el, obs), reps=5)
    split["kfac_update_ms"] = cuda_ms(kfac_update, reps=5)
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(saved[k])

    reset_counts()
    adam_history, adam_warnings = train_cli(workdir / "adam", "adam", ADAM_ITERATIONS)
    _, adam_final, _ = LogManager.restore_checkpoint(
        workdir / "adam" / f"ckpt_{RESUME_STEP + ADAM_ITERATIONS - 1:06d}.npz")
    adam_energies = np.array([row["energy"].real for row in adam_history])
    dropped = "Restored opt_state (KfacState) does not match optimizer adam; reinitialising"

    step_times = [row["step_time"] for row in history]
    result = dict(
        iterations=len(history),
        kfac_step_entry=int(start.opt_state.step), kfac_step_exit=int(final.opt_state.step),
        kfac_weight_exit=float(final.opt_state.weight),
        learning_rate=history[0]["learning_rate"],
        mean_energy=float(energies.mean()),
        energy_sem=float(energies.std(ddof=1) / math.sqrt(len(energies))),
        mean_l_square=float(l_square.mean()),
        mean_variance=float(np.mean([row["variance"] for row in history])),
        norm_coefficients=[row["norm_coefficient"] for row in history],
        step_norm_over_constraint=max(step_norms) / cfg.optim.kfac.norm_constraint,
        params_moved_rel_l2=moved,
        step_time_median_ms=statistics.median(step_times) * 1e3,
        step_times_ms=[t * 1e3 for t in step_times],
        split_ms=split,
        wall_s=wall,
        peak_memory_gb=peak_gb,
        launches=counts, expected_launches=expected,
        kfac_gram_launches=gram_launches, expected_kfac_gram_launches=gram_expected,
        warnings=warnings,
        update_rel_l2=updates,
        after_training_fields=fields,
        adam=dict(iterations=len(adam_history), energies=adam_energies.tolist(),
                  state=type(adam_final.opt_state).__name__,
                  count=int(adam_final.opt_state.count) if isinstance(adam_final.opt_state, AdamState) else None,
                  warnings=adam_warnings),
    )
    emit(phase="train", **result)
    if len(history) != TRAIN_ITERATIONS or not np.isfinite(energies).all():
        raise AssertionError("train: missing iterations or non-finite energy")
    if result["kfac_step_exit"] != RESUME_STEP + TRAIN_ITERATIONS or not result["kfac_weight_exit"] > 0.999:
        raise AssertionError("train: the restored KfacState was not the one trained on")
    if abs(result["mean_energy"] - ANCHOR_ENERGY) > ANCHOR_TOL or not result["mean_l_square"] < 0.2:
        raise AssertionError(f"train: energy {result['mean_energy']} or L^2 {result['mean_l_square']} off")
    if not result["step_norm_over_constraint"] <= 1 + 1e-5:
        raise AssertionError("train: a step broke the norm constraint")
    if not moved > 0:
        raise AssertionError("train: the parameters did not move")
    if counts != expected:
        raise AssertionError(f"train: launch counts {counts} != expected {expected}")
    if gram_launches != gram_expected:
        raise AssertionError(f"train: {gram_launches} Gram-product launches != {gram_expected}")
    bad = [k for k, v in fields.items()
           if not (v["kernels_vs_plain_median_dev_rel"] <= END_TO_END_TOL
                   and v["kernels_vs_float64_mean_shift_sem"] <= MEAN_SHIFT_SEM)]
    if bad:
        raise AssertionError(f"train: after the updates the kernel path is off in {bad}")
    bad = float64_gate(fields)
    if bad:
        raise AssertionError(f"train: the kernel path is farther from float64 than float32 allows in {bad}")
    energy = fields["energy"]
    if not energy["stale_vs_plain_median_dev_rel"] >= 10 * energy["kernels_vs_plain_median_dev_rel"]:
        raise AssertionError("train: the comparison cannot tell the trained weights from the stored")
    if not updates["kernels_vs_float64"] <= 2 * updates["plain_vs_float64"]:
        raise AssertionError(f"train: the kernel path's KFAC update is off: {updates}")
    if (len(adam_history) != ADAM_ITERATIONS or not np.isfinite(adam_energies).all()
            or dropped not in adam_warnings or result["adam"]["count"] != ADAM_ITERATIONS):
        raise AssertionError(f"train: Adam {result['adam']}")
    return counts, history, gram_launches


def sector_cli(save: Path, *dotlist: str) -> list:
    """The training CLI on the sector-6 state with its fixed state, by absolute paths."""
    from deephall_tpu_torch import train

    return train.cli([
        "--yml", str(SECTOR / "config.yml"),
        f"log.restore_path={SECTOR / f'ckpt_{SECTOR_STEP - 1:06d}.npz'}",
        f"log.save_path={save}",
        f"system.orthogonal_states=[{GROUND_STATE}]",
        *dotlist,
    ])


def sector_means(history: list) -> dict:
    def mean(key):
        return float(np.mean([row[key].real if isinstance(row[key], complex) else row[key]
                              for row in history]))

    return dict(mean_energy=mean("energy"), mean_lz=mean("angular_momentum_z"),
                mean_l_square=mean("angular_momentum_square"), mean_overlap=mean("overlap"),
                mean_variance=mean("variance"))


def sector_gate(phase: str, history: list, means: dict, iterations: int,
                energy_tol: float = SECTOR_ENERGY[1]) -> None:
    values = [v for row in history for v in (row["energy"].real, row["angular_momentum_z"],
                                              row["angular_momentum_square"], row["overlap"])]
    if len(history) != iterations or not np.isfinite(values).all():
        raise AssertionError(f"{phase}: missing iterations or a NaN")
    for key, (want, tol) in (("mean_energy", (SECTOR_ENERGY[0], energy_tol)), ("mean_lz", SECTOR_LZ),
                             ("mean_l_square", SECTOR_L2)):
        if not abs(means[key] - want) <= tol:
            raise AssertionError(f"{phase}: {key} {means[key]} not within {tol} of {want}")
    if not means["mean_overlap"] < SECTOR_OVERLAP:
        raise AssertionError(f"{phase}: overlap {means['mean_overlap']} >= {SECTOR_OVERLAP}")


def phase_slice_excited(workdir: Path) -> dict:
    """Inference of the sector-6 state with its fixed state: the ENERGY_DIFF branch."""
    reset_counts()
    history = sector_cli(workdir / "sector_inference", "optim.optimizer=none",
                         f"optim.iterations={SECTOR_INFERENCE}", "mcmc.burn_in=10")
    torch.cuda.synchronize()
    counts = launch_counts()
    expected = {k: SECTOR_INFERENCE * v for k, v in launches_per_local_energy().items()}
    means = sector_means(history)
    emit(phase="slice_excited", iterations=len(history), **means,
         overlaps=[row["overlap"] for row in history], launches=counts, expected_launches=expected)
    # Five iterations after a short burn-in: the mean's spread is about twice
    # that of the training phase's ten.
    sector_gate("slice_excited", history, means, SECTOR_INFERENCE, energy_tol=2 * SECTOR_ENERGY[1])
    if counts != expected:
        raise AssertionError(f"slice_excited: launch counts {counts} != expected {expected}")
    return counts


def launches_per_local_energy(layers: int = 2, production: bool = True) -> dict:
    """Each kernel's launches in one local energy of the production Psiformer;
    every launch of the production shapes (N = 6) takes the kernel built for
    them, and at any other N (``production`` false) the staged LayerNorm and
    the streamed softmax/values kernel take every launch; the orbital head's
    kernel runs once at every N."""
    built = int(production)
    return {
        "jet_layernorm": 2 * layers, "jet_attention": layers, "jet_gemm": 2 * layers,
        "jet_softmax_values": layers, "jet_gemm_tensor_core": 2 * layers,
        "jet_softmax_values_tiled": built * layers, "jet_layernorm_streamed": built * 2 * layers,
        "jet_layernorm_staged": (1 - built) * 2 * layers, "orbital_head": 1,
    }


class SyncCount:
    """Synchronising calls inside the iteration blocks, their save flags and their
    statistics' host reads, by source line (``torch.cuda.set_sync_debug_mode("warn")``; the
    checkpoint saves and the set-up before the first block are not counted)."""

    def __init__(self):
        self.sources: list[str] = []
        self.blocks = 0

    def __enter__(self):
        from deephall_tpu_torch import train

        self.train = train
        self.make_block, self.host_rows = train.make_iteration_block, train.host_rows
        self.save_flags = train.save_flags

        def make_block(*args):
            block = self.make_block(*args)

            def counted(*block_args):
                self.blocks += 1
                return self.watch(block, *block_args)

            return counted

        train.make_iteration_block = make_block
        train.host_rows = lambda *args: self.watch(self.host_rows, *args)
        train.save_flags = lambda *args: self.watch(self.save_flags, *args)
        return self

    def watch(self, fn, *args):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn(*args)
            finally:
                torch.cuda.set_sync_debug_mode(0)
                self.sources.extend(f"{'/'.join(Path(w.filename).parts[-2:])}:{w.lineno}"
                                    for w in caught if "synchroniz" in str(w.message))

    def __exit__(self, *exc):
        self.train.make_iteration_block, self.train.host_rows = self.make_block, self.host_rows
        self.train.save_flags = self.save_flags

    def report(self) -> dict:
        return dict(blocks=self.blocks, syncs=len(self.sources),
                    syncs_per_block=len(self.sources) / max(self.blocks, 1),
                    sync_sources=sorted(set(self.sources)))


def phase_excited(workdir: Path) -> dict:
    """Excited-state training: sector 6 resumed under KFAC through the CLI."""
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.observables import runner

    iterations = f"optim.iterations={SECTOR_STEP + SECTOR_ITERATIONS}"
    trace_dir = workdir / "excited" / "trace"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    with SyncCount() as syncs:
        history = sector_cli(workdir / "excited", "optim.optimizer=kfac", iterations,
                             "optim.block_size=10", f"log.profile_dir={trace_dir}",
                             "log.profile_start=2", "log.profile_steps=3")
    torch.cuda.synchronize()
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k: SECTOR_ITERATIONS * v for k, v in launches_per_local_energy().items()}
    _, final, _ = LogManager.restore_checkpoint(
        workdir / "excited" / f"ckpt_{SECTOR_STEP + SECTOR_ITERATIONS - 1:06d}.npz")
    cfg = runner.load_config(SECTOR / f"ckpt_{SECTOR_STEP - 1:06d}.npz")
    step_norms = [row["learning_rate"] ** 2 * row["norm_coefficient"] ** 2 * row["quadratic_norm"]
                  for row in history]

    # The same code in blocks of 1, and again in one block without the profiler.
    with SyncCount() as syncs_one:
        per_iteration = sector_cli(workdir / "excited_block1", "optim.optimizer=kfac", iterations,
                                   "optim.block_size=1")
    with SyncCount() as syncs_unprofiled:
        unprofiled = sector_cli(workdir / "excited_block10", "optim.optimizer=kfac", iterations,
                                "optim.block_size=10")
    times_one = [row["step_time"] * 1e3 for row in per_iteration]
    means = sector_means(history)
    result = dict(
        iterations=len(history), **means,
        overlaps=[row["overlap"] for row in history],
        kfac_step_exit=int(final.opt_state.step),
        step_norm_over_constraint=max(step_norms) / cfg.optim.kfac.norm_constraint,
        launches=counts, expected_launches=expected,
        block10=syncs_unprofiled.report(), block1=syncs_one.report(),
        block10_profiled=syncs.report(),
        step_time_block10_ms=unprofiled[0]["step_time"] * 1e3,
        step_time_block10_profiled_ms=history[0]["step_time"] * 1e3,
        step_time_block1_median_ms=statistics.median(times_one[1:]),
        step_times_block1_ms=times_one,
        trace=str(trace_dir / "trace.json"), trace_exists=(trace_dir / "trace.json").exists(),
        trace_mb=(trace_dir / "trace.json").stat().st_size / 1e6 if (trace_dir / "trace.json").exists() else 0,
        peak_memory_gb=peak_gb,
    )
    emit(phase="excited", **result)
    sector_gate("excited", history, means, SECTOR_ITERATIONS)
    if result["kfac_step_exit"] != SECTOR_STEP + SECTOR_ITERATIONS:
        raise AssertionError("excited: the restored KfacState was not the one trained on")
    if not result["step_norm_over_constraint"] <= 1 + 1e-5:
        raise AssertionError("excited: a step broke the norm constraint")
    if counts != expected:
        raise AssertionError(f"excited: launch counts {counts} != expected {expected}")
    if not result["trace_exists"]:
        raise AssertionError("excited: no profiler trace")
    # The profiler's own waits are listed (block10_profiled), not gated.
    for key, blocks in (("block10", 1), ("block1", SECTOR_ITERATIONS)):
        if not (result[key]["blocks"] == blocks and result[key]["syncs_per_block"] <= 1):
            raise AssertionError(f"excited: synchronising calls in the blocks: {key} {result[key]}")
    if len(per_iteration) != SECTOR_ITERATIONS or len(unprofiled) != SECTOR_ITERATIONS:
        raise AssertionError("excited: the block-1 or the unprofiled run is short")
    return counts


def no_launches(phase: str, counts: dict) -> None:
    if any(counts.values()):
        raise AssertionError(f"{phase}: kernels launched: {counts}")


def phase_laughlin(workdir: Path, device) -> None:
    """Inference of the analytic Laughlin state at N=6, 2Q=15 through the CLI."""
    from deephall_tpu_torch import loss, mcmc, train
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.observables import runner

    save = workdir / "laughlin"
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    history = train.cli([
        "system.nspins=[6,0]", "system.flux=15", "network.type=laughlin",
        "optim.optimizer=none", f"batch_size={BATCH}",
        f"optim.iterations={LAUGHLIN_ITERATIONS}", f"log.save_path={save}",
    ])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    counts = launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # Per walker, on the run's last walkers.
    ckpt = save / f"ckpt_{LAUGHLIN_ITERATIONS - 1:06d}.npz"
    cfg = runner.load_config(ckpt)
    _, final, _ = LogManager.restore_checkpoint(ckpt)
    model = make_network(cfg.system, cfg.network).to(device)
    data = torch.as_tensor(final.data, device=device)
    local_energy = loss.batched_local_energy(model, cfg.system)
    with torch.no_grad():
        _, obs = local_energy(data)
    kinetic = obs["kinetic"].real.double()
    deviation = (kinetic - LAUGHLIN_KINETIC).abs()
    sweep = mcmc.make_mcmc_step(lambda x: model(x, train.sweep_dtype()), steps=cfg.mcmc.steps)
    gen = torch.Generator(device=device).manual_seed(0)
    with torch.no_grad():
        split = dict(sweep_ms=cuda_ms(lambda: sweep(data, float(final.mcmc_width), gen), reps=5),
                     local_energy_ms=cuda_ms(lambda: local_energy(data), reps=5))

    # The pole walkers of scripts/torch_laughlin_pole_probe.py: one electron at
    # pi - eps and at eps; the exact kinetic energy 3 and L^2 0 at every one.
    probe = script_module("torch_laughlin_pole_probe")
    pole = torch.from_numpy(probe.pole_walkers(walkers=2 * len(probe.POLE_EPS))).to(device)
    with torch.no_grad():
        _, pole_obs = local_energy(pole)
    pole_kinetic = (pole_obs["kinetic"].real - LAUGHLIN_KINETIC).abs()
    pole_l2 = pole_obs["angular_momentum_square"].abs()

    energies = np.array([row["energy"].real for row in history])
    l_square = np.array([row["angular_momentum_square"] for row in history])
    run_kinetic = np.array([row["kinetic"].real for row in history])
    step_times = [row["step_time"] for row in history]
    result = dict(
        iterations=len(history), burn_in=cfg.mcmc.burn_in,
        mean_energy=float(energies.mean()),
        energy_sem=float(energies.std(ddof=1) / math.sqrt(len(energies))),
        mean_l_square=float(l_square.mean()), max_l_square=float(np.abs(l_square).max()),
        mean_kinetic_of_run=float(run_kinetic.mean()),
        mean_variance=float(np.mean([row["variance"] for row in history])),
        mean_pmove=float(np.mean([row["pmove"] for row in history])),
        kinetic_median_walker=kinetic.median().item(), kinetic_batch_mean=kinetic.mean().item(),
        kinetic_max_deviation=deviation.max().item(),
        kinetic_max_deviation_theta=data[deviation.argmax(), :, 0].tolist(),
        step_time_median_ms=statistics.median(step_times) * 1e3,
        split_ms=split, wall_s=wall, peak_memory_gb=peak_gb, launches=counts,
        pole=dict(eps=list(probe.POLE_EPS), theta=pole[:, 0, 0].tolist(),
                  dtype=str(pole_obs["kinetic"].dtype),
                  kinetic_deviation=pole_kinetic.tolist(), abs_l_square=pole_l2.tolist()),
    )
    emit(phase="laughlin", **result)
    values = np.concatenate([energies, l_square, run_kinetic, kinetic.cpu().numpy()])
    if len(history) != LAUGHLIN_ITERATIONS or not np.isfinite(values).all():
        raise AssertionError("laughlin: missing iterations or a NaN")
    if not abs(result["mean_energy"] - LAUGHLIN_ENERGY) <= LAUGHLIN_TOL:
        raise AssertionError(f"laughlin: mean energy {result['mean_energy']} not within "
                             f"{LAUGHLIN_TOL} of {LAUGHLIN_ENERGY}")
    if not abs(result["mean_l_square"]) < LAUGHLIN_L2:
        raise AssertionError(f"laughlin: mean L^2 {result['mean_l_square']} >= {LAUGHLIN_L2}")
    for key in ("kinetic_median_walker", "kinetic_batch_mean"):
        if not abs(result[key] - LAUGHLIN_KINETIC) <= KINETIC_TOL:
            raise AssertionError(f"laughlin: {key} {result[key]} not within {KINETIC_TOL} of 3")
    if not (pole_kinetic.max().item() <= POLE_TOL and pole_l2.max().item() <= POLE_TOL):
        raise AssertionError(f"laughlin: a pole walker off by more than {POLE_TOL}: {result['pole']}")
    no_launches("laughlin", counts)


def hessian_local_energy(model, system):
    """The full-Hessian local energy of the Psiformer's plain forward, batched."""
    from deephall_tpu_torch.hamiltonian import local_energy

    return torch.func.vmap(local_energy(lambda x: model(x[None])[0], system))


def phase_hessian(device) -> dict:
    """The kernel jet against a derivative route that shares none of its rules."""
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    cfg, model, state = restored_model(GROUND_STATE, device)
    model.requires_grad_(False)
    model64 = copy.deepcopy(model).double()
    data = torch.as_tensor(state.data[:HESSIAN_WALKERS], device=device)
    routes = {
        "kernels": (forward_laplacian_local_energy(model, cfg.system, kernels=True), data),
        "plain": (forward_laplacian_local_energy(model, cfg.system, kernels=False), data),
        "hessian": (hessian_local_energy(model, cfg.system), data),
        "float64": (hessian_local_energy(model64, cfg.system), data.double()),
    }
    out, timing = {}, {}
    with torch.no_grad():
        for name, (fn, x) in routes.items():
            if name == "kernels":
                reset_counts()
            el, obs = fn(x)
            torch.cuda.synchronize()
            if name == "kernels":
                counts = launch_counts()
            out[name] = {"energy": el, **obs}
        for name, (fn, x) in routes.items():
            timing[f"{name}_ms"] = cuda_ms(lambda: fn(x), reps=3, warmup=1)
    report = {}
    for key in out["float64"]:
        vals = {name: v[key].real.double() for name, v in out.items()}
        truth, hess = vals["float64"], vals["hessian"]
        rms, rms_hess = truth.square().mean().sqrt().item(), hess.square().mean().sqrt().item()
        mean = {name: v.mean().item() for name, v in vals.items()}
        report[key] = dict(
            rms=rms,
            kernels_vs_hessian_mean_shift_rel=abs(mean["kernels"] - mean["hessian"]) / rms_hess,
            kernels_vs_hessian_median_dev_rel=(vals["kernels"] - hess).abs().median().item() / rms_hess,
            **{f"{name}_vs_float64_median_dev_rel": (vals[name] - truth).abs().median().item() / rms
               for name in ("kernels", "plain", "hessian")},
            **{f"{name}_vs_float64_mean_shift_rel": abs(mean[name] - mean["float64"]) / rms
               for name in ("kernels", "plain", "hessian")},
        )
    expected = launches_per_local_energy(cfg.network.psiformer.num_layers)
    emit(phase="hessian", walkers=HESSIAN_WALKERS, tolerance=END_TO_END_TOL, fields=report,
         launches=counts, expected_launches=expected, **timing)
    bad = [k for k, v in report.items()
           if not (v["kernels_vs_hessian_mean_shift_rel"] <= END_TO_END_TOL
                   and v["kernels_vs_hessian_median_dev_rel"] <= END_TO_END_TOL)]
    if bad:
        raise AssertionError(f"hessian: the kernel jet and the Hessian path differ in {bad}")
    bad = float64_gate(report)
    if bad:
        raise AssertionError(f"hessian: the kernel jet is farther from float64 than float32 allows in {bad}")
    if counts != expected:
        raise AssertionError(f"hessian: launch counts {counts} != expected {expected}")
    return counts


def phase_ed_state(device) -> None:
    """The exact ED ground state through the full-Hessian path in complex128."""
    from deephall_tpu_torch.hamiltonian import local_energy
    from deephall_tpu_torch.networks.edstate import make_ed_network

    cfg, _, state = restored_model(GROUND_STATE, device)
    start = time.perf_counter()
    network, result = make_ed_network(cfg.system)
    ed_s = time.perf_counter() - start
    data = torch.as_tensor(state.data[:HESSIAN_WALKERS], device=device, dtype=torch.float64)
    batched = torch.func.vmap(local_energy(network, cfg.system), chunk_size=ED_CHUNK)
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    el, obs = batched(data)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    counts = launch_counts()
    kinetic_dev = (obs["kinetic"] - LAUGHLIN_KINETIC).abs()
    l2_dev = obs["angular_momentum_square"].abs()
    total = result.total_energy(sum(cfg.system.nspins))
    report = dict(
        dim=result.dim, ed_seconds=ed_s, total_energy=total, ground_l2=result.ground_l2,
        walkers=HESSIAN_WALKERS, dtype=str(el.dtype),
        kinetic_max_deviation=kinetic_dev.max().item(), l_square_max_deviation=l2_dev.max().item(),
        lz_max=obs["angular_momentum_z"].abs().max().item(),
        mean_local_energy=el.real.mean().item(),
        local_energy_s=seconds, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
        launches=counts,
    )
    emit(phase="ed_state", **report)
    if result.dim != 338 or not torch.isfinite(el).all():
        raise AssertionError("ed_state: wrong block or a NaN")
    if not (report["kinetic_max_deviation"] <= ED_TOL and report["l_square_max_deviation"] <= ED_TOL):
        raise AssertionError("ed_state: the kinetic energy or L^2 is off at a walker")
    if not abs(total - ED_ENERGY) <= ED_TOL:
        raise AssertionError(f"ed_state: ED energy {total} not within {ED_TOL} of {ED_ENERGY}")
    no_launches("ed_state", counts)


class StepWatch(SyncCount):
    """Synchronising calls inside the steps of ``evaluate_observable`` (its
    sweep, its estimator and its width update, by source line) and a CUDA
    event after each step's estimator; the set-up and the digest are outside."""

    def __enter__(self):
        from deephall_tpu_torch import mcmc
        from deephall_tpu_torch.observables import estimators

        self.mcmc, self.estimators = mcmc, estimators
        self.saved = (mcmc.make_mcmc_step, mcmc.adapt_width, dict(estimators.ESTIMATORS))
        self.events: list = []
        make_step, adapt_width, factories = self.saved

        def make_mcmc_step(*args, **kwargs):
            step = make_step(*args, **kwargs)
            return lambda *step_args: self.watch(step, *step_args)

        mcmc.make_mcmc_step = make_mcmc_step
        mcmc.adapt_width = lambda *args: self.watch(adapt_width, *args)
        for name, factory in factories.items():
            estimators.ESTIMATORS[name] = self.timed(factory)
        return self

    def timed(self, factory):
        def make(*args, **kwargs):
            est = factory(*args, **kwargs)

            def evaluate(*eval_args):
                state = self.watch(est.evaluate, *eval_args)
                event = torch.cuda.Event(enable_timing=True)
                event.record()
                self.events.append(event)
                return state

            return est._replace(evaluate=evaluate)

        return make

    def __exit__(self, *exc):
        self.mcmc.make_mcmc_step, self.mcmc.adapt_width, factories = self.saved
        self.estimators.ESTIMATORS.update(factories)

    def step_ms(self) -> list[float]:
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in zip(self.events, self.events[1:])]


def plain(value):
    """An array as JSON: a list, or ``{"re": ..., "im": ...}`` when complex."""
    a = np.asarray(value)
    if np.iscomplexobj(a):
        return {"re": a.real.tolist(), "im": a.imag.tolist()}
    return a.tolist()


def observable_gate(name: str, out: dict, steps: int) -> list[str]:
    """The physics gates of one run of phase ``observables``; returns the failures."""
    bad = []
    if name in ("ed_overlap", "ed_overlap_sector_6", "overlap_laughlin"):
        want, tol = {"ed_overlap": (ED_OVERLAP, ED_OVERLAP_TOL),
                     "ed_overlap_sector_6": (SECTOR_ED_OVERLAP, SECTOR_ED_OVERLAP_TOL),
                     "overlap_laughlin": (1.0, 1e-4)}[name]
        overlap = float(out["overlap"])
        if not (abs(overlap - want) <= tol and overlap <= 1 + 1e-6):
            bad.append(f"overlap {overlap} not within {tol} of {want} or above 1")
    elif name == "structure_factor":
        s_l = np.asarray(out["structure_factor"], dtype=np.float64)
        with np.load(REPO / "artifacts/prod_r4/structure_factor_n6q15.npz") as f:
            stored = np.asarray(f["vmc_s_l"], dtype=np.float64)
        if not abs(s_l[0] - 6.0) <= 1e-6:
            bad.append(f"S_0 = {s_l[0]}")
        if not np.all(np.abs(s_l[1:] - stored[1:]) <= STRUCTURE_FACTOR_TOL):
            bad.append(f"S_L {s_l.tolist()} not within {STRUCTURE_FACTOR_TOL} of {stored.tolist()}")
        if int(np.argmax(s_l[1:])) + 1 != 4:
            bad.append(f"S_L peaks at L = {int(np.argmax(s_l[1:])) + 1}")
    elif name == "one_rdm":
        rdm, trace = np.asarray(out["one_rdm"]), complex(out["trace"])
        if rdm.shape != (16, 16) or not np.isfinite(rdm).all():
            bad.append(f"1-RDM shape {rdm.shape} or not finite")
        if not (abs(trace.real - 6.0) < TRACE_TOL and abs(trace.imag) < TRACE_TOL):
            bad.append(f"trace {trace}")
        if not np.all(np.abs(np.diagonal(rdm) - 6 / 16) <= OCCUPATION_TOL):
            bad.append(f"occupations {np.diagonal(rdm).tolist()}")
    elif name == "density":
        if float(np.sum(out["map"])) != steps * BATCH * 6:
            bad.append(f"density mass {float(np.sum(out['map']))}")
    elif name == "pair_corr":
        g = np.asarray(out["pair_corr"])
        if not (np.isfinite(g).all() and g[:5].sum() < 0.1 * g[100:105].sum()):
            bad.append(f"no correlation hole: {g[:5].sum()} vs {g[100:105].sum()}")
    return bad


def phase_observables(workdir: Path, laughlin_ckpt: Path, smi: str) -> None:
    """The observables CLI on the stored states at full width (no kernels)."""
    from deephall_tpu_torch.observables import runner

    report, failures = {}, []
    for name, ckpt, estimator, steps, flags in OBSERVABLE_RUNS:
        out_file = workdir / f"observable_{name}.npz"
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        with StepWatch() as watch:
            runner.cli([str(ckpt or laughlin_ckpt), "--estimator", estimator,
                        "--steps", str(steps), "--out", str(out_file), *flags])
        seconds = time.perf_counter() - start
        step_ms = watch.step_ms()
        with np.load(out_file) as f:
            out = {k: f[k] for k in f.files}
        counts = launch_counts()
        bad = observable_gate(name, out, steps)
        if any(counts.values()):
            bad.append(f"kernels launched: {counts}")
        syncs = watch.report()
        if syncs["syncs"]:
            bad.append(f"synchronising calls inside the steps: {syncs['sync_sources']}")
        if len(watch.events) != steps:
            bad.append(f"{len(watch.events)} estimator steps, not {steps}")
        failures.extend(f"{name}: {b}" for b in bad)
        values = {k: plain(out[k]) for k in ("overlap", "structure_factor", "trace", "diagonal")
                  if k in out}
        report[name] = dict(
            checkpoint=str(ckpt or laughlin_ckpt), estimator=estimator, steps=steps,
            step_ms_median=statistics.median(step_ms) if step_ms else None,
            seconds=seconds, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
            syncs_in_steps=syncs["syncs"], sync_sources=syncs["sync_sources"],
            launches=sum(counts.values()), ok=not bad, **values)
        emit(phase="observable", name=name, nvidia_smi=smi, **report[name])
    emit(phase="observables", nvidia_smi=smi, runs=len(report),
         seconds=sum(r["seconds"] for r in report.values()), failures=failures)
    if failures:
        raise AssertionError(f"observables: {failures}")


def copied(v):
    """``v`` with every tensor in it cloned (tuples, named tuples, dicts)."""
    if isinstance(v, torch.Tensor):
        return v.clone()
    if isinstance(v, dict):
        return {k: copied(x) for k, x in v.items()}
    if isinstance(v, tuple):
        items = [copied(x) for x in v]
        return type(v)(*items) if hasattr(v, "_fields") else tuple(items)
    return v


def shard_kernels(device, rank: int, ranks: int) -> dict:
    """This rank's rows of ``prod_r4``'s walkers through the local energy, with
    each kernel wrapper's inputs recorded; then each wrapper against its plain
    version on every recorded input, and the local energy through the kernels
    against the plain path.  Run after the launch counts are read."""
    from deephall_tpu_torch.ops import jet_attention as ja
    from deephall_tpu_torch.ops import jet_layernorm as jl

    # name: (module, wrapper, its plain version, the counter of the kernel
    # built for the production shapes)
    wrappers = {
        "jet_layernorm": (jl, "layernorm_jet", jl.layernorm_jet_plain, "launches_streamed"),
        "jet_attention": (ja, "attention_jet", ja.attention_jet_plain, None),
        "jet_gemm": (ja, "jet_gemm", lambda a, w, b, r: ja.jet_gemm_plain(a, w.w, b, r),
                     "launches_tensor_core"),
        "jet_softmax_values": (ja, "softmax_values", ja.softmax_values_plain, "launches_tiled"),
    }
    cfg, model, state = restored_model(GROUND_STATE, device)
    model.requires_grad_(False)
    rows = BATCH // ranks
    data = torch.as_tensor(state.data[rank * rows:(rank + 1) * rows], device=device)
    calls, originals = [], {name: getattr(m, attr) for name, (m, attr, _, _) in wrappers.items()}

    def recorder(name, fn):
        def record(*args, **kwargs):
            calls.append((name, copied(args), copied(kwargs)))
            return fn(*args, **kwargs)

        record.__dict__.update(fn.__dict__)  # the counters a wrapper adds to by its name
        return record

    try:
        for name, (module, attr, _, _) in wrappers.items():
            setattr(module, attr, recorder(name, originals[name]))
        agreement, bad = path_agreement(model, cfg.system, data)
    finally:
        for name, (module, attr, _, _) in wrappers.items():
            setattr(module, attr, originals[name])
    report = {name: dict(calls=0, production=0, max_abs_err=0.0, max_rel_err=0.0)
              for name in wrappers}
    with torch.no_grad():
        while calls:
            name, args, kwargs = calls.pop(0)
            module, attr, plain_fn, counter = wrappers[name]
            fn = getattr(module, attr)
            before = getattr(fn, counter) if counter else 0
            got, want = fn(*args, **kwargs), plain_fn(*args, **kwargs)
            row = report[name]
            row["calls"] += 1
            row["production"] += getattr(fn, counter) - before if counter else 1
            for a, b in zip(got, want) if isinstance(got, tuple) else ((got, want),):
                err, rel = field_error(a, b)
                row["max_abs_err"] = max(row["max_abs_err"], err)
                row["max_rel_err"] = max(row["max_rel_err"], rel)
            del args, kwargs, got, want
    torch.cuda.empty_cache()
    return dict(walkers=rows, kernels=report, local_energy=agreement, local_energy_off=bad)


def rank_child(kind: str, argv: list[str]) -> int:
    """One rank of phase ``distributed`` (``chip_smoke.py --rank-child train|runner
    ARGS``): the training or observables CLI with ``ARGS``, then one JSON line
    with this rank's launch counts and, after training, its statistics, the
    SHA-256 of its parameters' bytes and :func:`shard_kernels`."""
    sys.path.insert(0, str(REPO))
    from deephall_tpu_torch import train
    from deephall_tpu_torch.observables import runner

    reset_counts()
    if kind == "runner":
        runner.cli(argv)
        torch.cuda.synchronize()
        emit(rank=int(os.environ["RANK"]), launches=launch_counts())
        return 0
    made = []
    make_network = train.make_network
    train.make_network = lambda *args: made.append(make_network(*args)) or made[-1]
    history = train.cli(argv)
    torch.cuda.synchronize()
    counts = launch_counts()
    params = b"".join(p.detach().cpu().numpy().tobytes() for p in made[0].parameters())
    rank = int(os.environ["RANK"])
    emit(rank=rank, launches=counts,
         shard_kernels=shard_kernels(next(made[0].parameters()).device, rank,
                                     int(os.environ["WORLD_SIZE"])),
         checksum=hashlib.sha256(params).hexdigest(),
         energies=[row["energy"].real for row in history],
         l_square=[row["angular_momentum_square"] for row in history],
         step_norms=[row["learning_rate"] ** 2 * row["norm_coefficient"] ** 2
                     * row["quadratic_norm"] for row in history],
         step_times_ms=[row["step_time"] * 1e3 for row in history])
    return 0


def spawn_ranks(kind: str, argv: list[str], ranks: int, device: str,
                backend: str) -> list[tuple[dict, str]]:
    """``ranks`` child processes of this script as one torchrun-style launch;
    returns each rank's JSON line and its standard error."""
    from deephall_tpu_torch import parallel

    port = parallel.rendezvous_port()
    procs = []
    for rank in range(ranks):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, str(REPO / "chip_smoke.py"), "--rank-child", kind, *argv,
             "--device", device, "--backend", backend],
            cwd=REPO, env=env, text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for rank, proc in enumerate(procs):
            out, err = proc.communicate(timeout=CHILD_TIMEOUT)
            if proc.returncode != 0:
                raise AssertionError(f"distributed: {kind} rank {rank} exited {proc.returncode}:"
                                     f"\n{err[-4000:]}")
            outs.append((json.loads(out.strip().splitlines()[-1]), err))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return outs


def two_rank_training(name: str, workdir: Path, device: str, backend: str, train_history: list,
                      cfg_constraint: float) -> tuple[dict, list[str]]:
    """Phase ``train``'s 10 KFAC iterations on two ranks; returns the report and
    the failed gates."""
    from deephall_tpu_torch.log import LogManager

    save = workdir / name
    start = time.perf_counter()
    outs = [out for out, _ in spawn_ranks(
        "train", prod_r4_argv(save, "kfac", TRAIN_ITERATIONS), 2, device, backend)]
    seconds = time.perf_counter() - start
    _, final, _ = LogManager.restore_checkpoint(
        save / f"ckpt_{RESUME_STEP + TRAIN_ITERATIONS - 1:06d}.npz")
    energies = np.array(outs[0]["energies"])
    want = np.array([row["energy"].real for row in train_history])
    sem = np.sqrt(np.array([row["variance"] for row in train_history]) / BATCH)
    gaps = np.abs(energies - want) / sem
    expected = {k: TRAIN_ITERATIONS * v for k, v in launches_per_local_energy().items()}
    report = dict(
        device=device, backend=backend, walkers_per_rank=BATCH // 2, seconds=seconds,
        mean_energy=float(energies.mean()), mean_l_square=float(np.mean(outs[0]["l_square"])),
        largest_gap_sem=float(gaps.max()), energies=energies.tolist(),
        first_energy_rel_diff=float(abs(energies[0] - want[0]) / abs(want[0])),
        step_norm_over_constraint=max(max(o["step_norms"]) for o in outs) / cfg_constraint,
        checksums=[o["checksum"] for o in outs], checkpoint_data=list(final.data.shape),
        kfac_step_exit=int(final.opt_state.step),
        step_time_median_ms=[statistics.median(o["step_times_ms"]) for o in outs],
        launches=[o["launches"] for o in outs], expected_launches=expected,
        shard_kernels=[o["shard_kernels"] for o in outs],
    )
    bad = []
    values = [v for o in outs for v in (*o["energies"], *o["l_square"])]
    if len(energies) != TRAIN_ITERATIONS or not np.isfinite(values).all():
        bad.append("missing iterations or a NaN")
    if not (abs(report["mean_energy"] - ANCHOR_ENERGY) <= ANCHOR_TOL
            and report["mean_l_square"] < 0.2):
        bad.append(f"energy {report['mean_energy']} or L^2 {report['mean_l_square']} off")
    if not report["step_norm_over_constraint"] <= 1 + 1e-5:
        bad.append("a step broke the norm constraint")
    if report["checkpoint_data"] != [BATCH, 6, 2] or report["kfac_step_exit"] != RESUME_STEP + TRAIN_ITERATIONS:
        bad.append(f"checkpoint data {report['checkpoint_data']}, step {report['kfac_step_exit']}")
    if len(set(report["checksums"])) != 1:
        bad.append("the ranks' parameters differ")
    if not report["largest_gap_sem"] <= DIST_SEM:
        bad.append(f"an energy lies {report['largest_gap_sem']:.2f} standard errors from phase train's")
    if not report["first_energy_rel_diff"] <= DIST_ENERGY_REL:
        bad.append(f"the first energy lies {report['first_energy_rel_diff']:.2e} from phase train's")
    for rank, shard in enumerate(report["shard_kernels"]):
        for kernel, row in shard["kernels"].items():
            if not (row["calls"] > 0 and row["production"] == row["calls"]
                    and row["max_rel_err"] <= KERNEL_TOL):
                bad.append(f"rank {rank}: {kernel} at {shard['walkers']} walkers: {row}")
        if shard["local_energy_off"]:
            bad.append(f"rank {rank}: the local energy's {shard['local_energy_off']} differ "
                       f"by more than {END_TO_END_TOL}")
    if any(counts != expected for counts in report["launches"]):
        bad.append(f"launches {report['launches']} != {expected} on each rank")
    if outs[0]["energies"] != outs[1]["energies"]:
        bad.append("the ranks' statistics differ")
    return report, [f"{name}: {b}" for b in bad]


class CollectiveCount:
    """Counts the ``torch.distributed`` collectives called inside the block, by kind."""

    KINDS = ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast")

    def __enter__(self):
        import torch.distributed as dist

        self.dist, self.saved, self.counts = dist, {}, dict.fromkeys(self.KINDS, 0)
        for kind in self.KINDS:
            fn = self.saved[kind] = getattr(dist, kind)

            def counted(*args, _fn=fn, _kind=kind, **kwargs):
                self.counts[_kind] += 1
                return _fn(*args, **kwargs)

            setattr(dist, kind, counted)
        return self

    def __exit__(self, *exc):
        for kind, fn in self.saved.items():
            setattr(self.dist, kind, fn)


def collective_costs(device, calls: int = 200) -> list[dict]:
    """In the process group joined: the host's and the card's time (µs) for one
    call of each collective at the sizes a training step uses, each the median
    of ``calls`` calls in a row, beside a ``torch.add`` of two numbers."""
    from deephall_tpu_torch import parallel
    from deephall_tpu_torch.log import LogManager

    def numel(tree: dict) -> int:
        return sum(numel(v) if isinstance(v, dict) else np.size(v) for v in tree.values())

    _, state, _ = LogManager.restore_checkpoint(GROUND_STATE)
    # A statistic's sum and count, the gradient buffer (every parameter), the
    # KFAC moments, a gather of every walker's complex energy.
    stat = torch.ones(2, device=device)
    grads = torch.ones(numel(state.params), device=device)
    moments = torch.ones(numel(state.opt_state.kron) + numel(state.opt_state.diag), device=device)
    energies = torch.ones(BATCH, 2, device=device)
    cases = (
        ("all_reduce_sum statistic", stat.numel(), lambda: parallel.all_reduce_sum(stat)),
        ("all_reduce_sum gradient", grads.numel(), lambda: parallel.all_reduce_sum(grads)),
        ("all_reduce_mean moments", moments.numel(), lambda: parallel.all_reduce_mean(moments)),
        ("all_gather_rows energies", energies.numel(), lambda: parallel.all_gather_rows(energies)),
        ("torch.add statistic", stat.numel(), lambda: torch.add(stat, stat)),
    )
    rows = []
    for name, floats, fn in cases:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        wall = time.perf_counter()
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        host_us = (time.perf_counter() - wall) / calls * 1e6
        end.synchronize()
        rows.append(dict(case=name, floats=floats, host_us=host_us,
                         device_us=start.elapsed_time(end) / calls * 1e3))
    return rows


def one_rank_launch() -> dict:
    from deephall_tpu_torch import parallel

    return dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                MASTER_PORT=str(parallel.rendezvous_port()))


def phase_distributed(workdir: Path, train_history: list, train_counts: dict, smi: str) -> None:
    """Walker data parallelism: a one-rank NCCL group, two gloo ranks on one card,
    the observables runner on two ranks, and NCCL across cards where there are two."""
    import yaml

    from deephall_tpu_torch import parallel, train
    from deephall_tpu_torch.log import LogManager

    constraint = yaml.safe_load((REPO / "artifacts/prod_r4/config.yml").read_text())
    constraint = constraint["optim"]["kfac"]["norm_constraint"]
    failures, report = [], {}

    # nccl_1: a real NCCL group of one rank, in this process; then the cost of
    # each collective in the group that the CLI joined and kept.
    launch = one_rank_launch()
    os.environ.update(launch)
    reset_counts()
    start = time.perf_counter()
    try:
        with SyncCount() as syncs, CollectiveCount() as collectives:
            history, _ = train_cli(workdir / "nccl_1", "kfac", TRAIN_ITERATIONS, "--backend", "nccl")
        counts = launch_counts()
        seconds = time.perf_counter() - start
        group_kept = torch.distributed.is_initialized()
        costs = collective_costs(parallel.initialize_distributed("cuda:0", "nccl"))
        parallel.shutdown_distributed()
    finally:
        for key in launch:
            os.environ.pop(key)
    energies = np.array([row["energy"].real for row in history])
    want = np.array([row["energy"].real for row in train_history])
    times = [row["step_time"] * 1e3 for row in history]
    report["nccl_1"] = dict(
        seconds=seconds, energies=energies.tolist(),
        largest_rel_diff=float(np.max(np.abs(energies - want) / np.abs(want))),
        step_time_median_ms=statistics.median(times), step_times_ms=times,
        train_step_time_median_ms=statistics.median(row["step_time"] * 1e3 for row in train_history),
        syncs=syncs.report(), launches=counts, group_kept=group_kept,
        collectives_per_iteration={k: v / TRAIN_ITERATIONS for k, v in collectives.counts.items()},
        collective_costs=costs,
    )
    emit(phase="distributed", part="nccl_1", nvidia_smi=smi, **report["nccl_1"])
    if len(energies) != TRAIN_ITERATIONS or not report["nccl_1"]["largest_rel_diff"] <= DIST_ENERGY_REL:
        failures.append(f"nccl_1: energies {report['nccl_1']['largest_rel_diff']:.2e} from phase train's")
    if counts != train_counts:
        failures.append(f"nccl_1: launches {counts} != phase train's {train_counts}")
    if not (syncs.blocks == TRAIN_ITERATIONS and syncs.report()["syncs_per_block"] <= 1):
        failures.append(f"nccl_1: synchronising calls {syncs.report()}")
    if not report["nccl_1"]["group_kept"]:
        failures.append("nccl_1: the CLI left its process group before the process ended")

    # gloo_2: two ranks on card 0, then the checkpoint resumed on one process.
    report["gloo_2"], bad = two_rank_training("gloo_2", workdir, "cuda:0", "gloo",
                                              train_history, constraint)
    failures.extend(bad)
    resumed = train.cli([
        "--yml", str(REPO / "artifacts/prod_r4/config.yml"), "optim.optimizer=kfac",
        f"log.restore_path={workdir / 'gloo_2' / f'ckpt_{RESUME_STEP + TRAIN_ITERATIONS - 1:06d}.npz'}",
        f"log.save_path={workdir / 'gloo_2_resumed'}",
        f"optim.iterations={RESUME_STEP + TRAIN_ITERATIONS + DIST_RESUME}",
    ])
    _, final, _ = LogManager.restore_checkpoint(
        workdir / "gloo_2_resumed" / f"ckpt_{RESUME_STEP + TRAIN_ITERATIONS + DIST_RESUME - 1:06d}.npz")
    report["gloo_2"]["resumed_on_one"] = dict(
        energies=[row["energy"].real for row in resumed], kfac_step_exit=int(final.opt_state.step))
    emit(phase="distributed", part="gloo_2", nvidia_smi=smi, **report["gloo_2"])
    if not (len(resumed) == DIST_RESUME and np.isfinite(report["gloo_2"]["resumed_on_one"]["energies"]).all()
            and int(final.opt_state.step) == RESUME_STEP + TRAIN_ITERATIONS + DIST_RESUME):
        failures.append(f"gloo_2: the resume on one process {report['gloo_2']['resumed_on_one']}")

    # runner_2: the ED overlap on two gloo ranks.
    out_file = workdir / "runner_2_ed_overlap.npz"
    start = time.perf_counter()
    outs = spawn_ranks("runner", [str(GROUND_STATE), "--estimator", "ed_overlap", "--steps", "100",
                                  "--out", str(out_file)], 2, "cuda:0", "gloo")
    with np.load(out_file) as f:
        overlap = float(f["overlap"])
    saved = [err.count("Saved") for _, err in outs]
    report["runner_2"] = dict(overlap=overlap, seconds=time.perf_counter() - start, saved=saved,
                              launches=[o["launches"] for o, _ in outs])
    emit(phase="distributed", part="runner_2", nvidia_smi=smi, **report["runner_2"])
    if not (abs(overlap - ED_OVERLAP) <= ED_OVERLAP_TOL and overlap <= 1 + 1e-6):
        failures.append(f"runner_2: overlap {overlap} not within {ED_OVERLAP_TOL} of {ED_OVERLAP}")
    if saved != [1, 0]:
        failures.append(f"runner_2: saves by rank {saved}")

    # nccl_2: one card a rank, where there are two.
    if torch.cuda.device_count() >= 2:
        report["nccl_2"], bad = two_rank_training("nccl_2", workdir, "cuda", "nccl",
                                                  train_history, constraint)
        failures.extend(bad)
    else:
        report["nccl_2"] = dict(run=False, reason=f"{torch.cuda.device_count()} card: NCCL "
                                "refuses two ranks on one card")
    emit(phase="distributed", part="nccl_2", nvidia_smi=smi, **report["nccl_2"])
    emit(phase="distributed", nvidia_smi=smi, failures=failures,
         seconds={k: v.get("seconds") for k, v in report.items()})
    if failures:
        raise AssertionError(f"distributed: {failures}")


def trace_summary(trace: Path, iterations: int) -> dict:
    """``scripts/torch_trace_summary.py`` on ``trace``: its JSON line."""
    done = subprocess.run(
        [sys.executable, str(REPO / "scripts" / "torch_trace_summary.py"), str(trace),
         "--iters", str(iterations), "--top", "10"],
        capture_output=True, text=True, timeout=600)
    if done.returncode != 0:
        raise AssertionError(f"the trace summary failed: {done.stderr[-2000:]}")
    return json.loads(done.stdout.strip().splitlines()[-1])


def phase_trace(workdir: Path, smi: str) -> dict:
    """One profiled block of prod_r4's KFAC training, read by scripts/torch_trace_summary.py."""
    from deephall_tpu_torch import train

    trace_dir = workdir / "trace" / "profile"
    window: dict = {}
    stop = train.Profile.stop

    def counted_stop(profile):
        if profile.profiler is not None:  # the counters at the end of the profiled window
            window.update(launch_counts())
        stop(profile)

    reset_counts()
    train.Profile.stop = counted_stop
    try:
        history, _ = train_cli(workdir / "trace", "kfac", TRACE_ITERATIONS + 1,
                               f"optim.block_size={TRACE_ITERATIONS}", f"log.profile_dir={trace_dir}",
                               "log.profile_start=0", f"log.profile_steps={TRACE_ITERATIONS}")
    finally:
        train.Profile.stop = stop
    trace = trace_dir / "trace.json"
    start = time.perf_counter()
    summary = trace_summary(trace, TRACE_ITERATIONS)
    per = launches_per_local_energy()
    hand_written = ("jet_layernorm", "jet_gemm", "jet_softmax_values")
    counted = {k: window.get(k) for k in hand_written}
    result = dict(
        iterations=len(history), trace_mb=trace.stat().st_size / 1e6,
        summary_s=time.perf_counter() - start,
        busy_share=summary["busy_share"], idle_share=summary["idle_share"],
        window_ms=summary["window_ms"], device_busy_ms=summary["device_busy_ms"],
        per_iteration=summary["per_iteration"], categories=summary["categories"],
        top=summary["top"], gaps=summary["gaps"],
        launches_in_trace=summary["hand_written_launches"], launches_counted=counted,
        # The profiler slows the host: the profiled block's iterations beside the one after it.
        step_time_profiled_ms=history[0]["step_time"] * 1e3,
        step_time_unprofiled_ms=history[-1]["step_time"] * 1e3,
    )
    emit(phase="trace", nvidia_smi=smi, **result)
    if len(history) != TRACE_ITERATIONS + 1 or not np.isfinite([r["energy"].real for r in history]).all():
        raise AssertionError("trace: missing iterations or a NaN")
    if counted != {k: TRACE_ITERATIONS * per[k] for k in hand_written}:
        raise AssertionError(f"trace: counted launches {counted} in the profiled window")
    if summary["hand_written_launches"] != counted:
        raise AssertionError(f"trace: launches in the trace {summary['hand_written_launches']} "
                             f"!= counted {counted}")
    if not 0 < summary["busy_share"] <= 1:
        raise AssertionError(f"trace: busy share {summary['busy_share']}")
    return window


def phase_magnetoroton(workdir: Path, smi: str) -> dict:
    """The port's sector driver (scripts/magnetoroton_torch.py) on one sector of prod_r4."""
    import csv

    from deephall_tpu_torch import train

    roton = script_module("magnetoroton_torch")
    run, stages, total = train.train, [], {}

    def stage(cfg, device):
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        start = time.perf_counter()
        history = run(cfg, device)
        torch.cuda.synchronize()
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        energies = [row["energy"].real for row in history]
        stages.append(dict(
            iterations=len(history), steps=[history[0]["step"], history[-1]["step"]] if history else [],
            seconds=time.perf_counter() - start,
            lz_penalty=cfg.system.lz_penalty, l2_penalty=cfg.system.l2_penalty,
            l2_center=cfg.system.l2_center, finite=bool(np.isfinite(energies).all()),
            energy=float(np.mean(energies)) if energies else None,
            l_square=float(np.mean([row["angular_momentum_square"] for row in history]))
            if history else None,
            launches=counts, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9))
        return history

    out = workdir / "roton"
    train.train = stage
    start = time.perf_counter()
    try:
        roton.main(["--config", str(REPO / "artifacts/prod_r4/config.yml"),
                    "--restore", str(GROUND_STATE), "--out", str(out),
                    "--sectors", str(ROTON_SECTOR), "--chain", "0",
                    "--iterations", str(ROTON_ITERATIONS), "--tail", str(ROTON_TAIL),
                    "--device", "cuda"])
    finally:
        train.train = run
    seconds = time.perf_counter() - start
    with open(out / "dispersion.csv") as f:
        rows = list(csv.DictReader(f))
    per = launches_per_local_energy()
    emit(phase="magnetoroton", nvidia_smi=smi, seconds=seconds, stages=stages, dispersion=rows,
         launches=total, peak_memory_gb=max((s["peak_memory_gb"] for s in stages), default=None))
    if len(stages) < 3 or not all(s["iterations"] and s["finite"] for s in stages):
        raise AssertionError(f"magnetoroton: a stage missing, empty or not finite: {stages}")
    for s in stages:
        want = {k: s["iterations"] * v for k, v in per.items()}
        if s["launches"] != want:
            raise AssertionError(f"magnetoroton: launches {s['launches']} != {want}")
    keys = ("energy", "energy_err", "variance", "L_square", "Lz")
    if not (len(rows) == 1 and rows[0]["sector"] == str(ROTON_SECTOR)
            and all(math.isfinite(float(rows[0][k])) for k in keys)):
        raise AssertionError(f"magnetoroton: dispersion.csv {rows}")
    if rows[0]["ed_energy"] == "" or abs(float(rows[0]["ed_l2"]) - ROTON_SECTOR * (ROTON_SECTOR + 1)) > 1e-6:
        raise AssertionError(f"magnetoroton: no ED row for Lz = {ROTON_SECTOR}: {rows[0]}")
    return total


def quiet(fn, *args):
    """``fn(*args)`` with its printed lines kept: ``(result, lines)``."""
    import contextlib
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args)
    return result, out.getvalue().splitlines()


def flops_counts() -> dict:
    """``scripts/torch_flops_count.py``, lean and ``--l2``, on the CPU, both at once:
    ``{mode: its JSON line}``."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": str(max(os.cpu_count() // 2, 1))}
    runs = {mode: subprocess.Popen(
        [sys.executable, str(REPO / "scripts" / "torch_flops_count.py"), *flags],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for mode, flags in (("lean", ()), ("l2", ("--l2",)))}
    out = {}
    try:
        for mode, run in runs.items():
            stdout, stderr = run.communicate(timeout=600)
            if run.returncode != 0:
                raise AssertionError(f"tools: torch_flops_count.py {mode} failed: {stderr[-2000:]}")
            lines = stdout.strip().splitlines()
            out[mode] = {**json.loads(lines[-1]), "lines": lines[:-1]}
    finally:
        for run in runs.values():
            run.kill()
            run.wait()
    return out


def sector_gap_ed(nelec: int, flux: int, m: int) -> float:
    """The exact gap of the ``L = m`` member of the ``Lz = m`` block over the
    ``Lz = 0`` ground state, from the port's ED."""
    from deephall_tpu_torch.observables import ed

    e0 = float(ed.ed_block(nelec, flux, two_lz=0, num_states=2).energies[0])
    block = ed.ed_block(nelec, flux, two_lz=2 * m, num_states=8)
    for k, energy in enumerate(block.energies):
        if abs(ed.state_l2(block, flux, k) - m * (m + 1)) < 0.5:
            return float(energy) - e0
    raise AssertionError(f"no L = {m} state in the Lz = {m} block")


def profile_parts(argv: list[str], per: dict) -> tuple[dict, list, list]:
    """``torch_profile_step.py ARGV``: ``(parts by name, its lines, problems)``,
    a problem unless every part is finite and positive, the local energy
    launches ``per`` a call and the block 10 times that."""
    result, lines = quiet(script_module("torch_profile_step").main, ["--device", "cuda", *argv])
    parts = {row["part"]: row for row in result["parts"]}
    problems = []
    bad = [k for k, row in parts.items() if not (math.isfinite(row["ms"]) and row["ms"] > 0)]
    if bad:
        problems.append(f"parts {bad} not finite and positive")
    if parts["local_energy"]["launches"] != per:
        problems.append(f"the local energy launched {parts['local_energy']['launches']}")
    if parts["block"]["launches"] != {k: TOOLS_BLOCK * v for k, v in per.items()}:
        problems.append(f"the block launched {parts['block']['launches']}")
    return parts, lines, problems


def tools_profile(report: dict, failures: list) -> None:
    """``torch_profile_step.py`` in both modes under :func:`profile_parts`."""
    for mode, flags in (("l2", []), ("lean", ["--fast"])):
        parts, lines, problems = profile_parts(flags, launches_per_local_energy())
        report[f"profile_{mode}"] = dict(lines=lines, parts=parts)
        failures.extend(f"profile {mode}: {problem}" for problem in problems)


def tools_trace(workdir: Path, report: dict, failures: list) -> None:
    """``torch_capture_trace.py --l2 --blocks 1`` read by the trace summary:
    10 x one local energy's launches of each kernel, the busy share in (0, 1]."""
    per = launches_per_local_energy()
    capture = script_module("torch_capture_trace")
    trace, _ = quiet(capture.main, ["--out", str(workdir / "tools_trace"), "--l2", "--blocks", "1"])
    summary = trace_summary(trace, TOOLS_BLOCK)
    report["trace"] = dict(
        trace_mb=trace.stat().st_size / 1e6, busy_share=summary["busy_share"],
        idle_share=summary["idle_share"], window_ms=summary["window_ms"],
        device_busy_ms=summary["device_busy_ms"], per_iteration=summary["per_iteration"],
        launches_in_trace=summary["hand_written_launches"], top=summary["top"][:5])
    want = {k: TOOLS_BLOCK * per[k] for k in ("jet_layernorm", "jet_gemm", "jet_softmax_values")}
    if summary["hand_written_launches"] != want:
        failures.append(f"trace: launches {summary['hand_written_launches']} != {want}")
    if not 0 < summary["busy_share"] <= 1:
        failures.append(f"trace: busy share {summary['busy_share']}")


def tools_benches(device, report: dict, failures: list) -> None:
    """The two microbenchmarks: the attention's kernel route within the kernel
    tolerance of its plain route, both layouts equal after the permutation."""
    bench = script_module("torch_bench_jet_attention")
    routes = bench.run(["kernel", "plain"], BATCH, device, 10)
    report["bench_jet_attention"] = routes
    bad = {k: v["max_rel_err"] for k, v in routes.items() if not v["max_rel_err"] <= KERNEL_TOL}
    if bad:
        failures.append(f"bench_jet_attention: routes off the plain route {bad}")
    layout = script_module("torch_bench_sublane_layout")
    layouts = layout.run(layout.SHAPE, device, 10)
    report["bench_sublane_layout"] = layouts
    if not layouts["max_abs_diff"] <= 1e-6 * layouts["max_abs"]:
        failures.append(f"bench_sublane_layout: the layouts differ by {layouts['max_abs_diff']}")
    torch.cuda.empty_cache()


def tools_count(report: dict, failures: list) -> None:
    """``torch_flops_count.py`` lean and ``--l2`` on the CPU, over the block-of-10
    iteration time of the step split: the rate, and the least time's share."""
    for mode, count in flops_counts().items():
        iteration_ms = report[f"profile_{mode}"]["parts"]["block"]["ms"]
        row = dict(
            flops=count["flops"], transcendentals=count["transcendentals"], bytes=count["bytes"],
            by_class=count["by_class"],
            parts={k: {f: v[f] for f in ("flops", "transcendentals", "bytes", "by_class")}
                   for k, v in count["parts"].items()},
            iteration_ms=iteration_ms,
            achieved_tflops=count["flops"] / (iteration_ms * 1e-3) / 1e12,
            operations_ms=count["operations_ms"], bytes_unfused_ms=count["bytes_ms"],
            operations_share=count["operations_ms"] / iteration_ms,
            bytes_unfused_share=count["bytes_ms"] / iteration_ms, lines=count["lines"])
        report["flops_count"][mode] = row
        numbers = (row["achieved_tflops"], row["operations_share"], row["bytes_unfused_share"])
        if not all(math.isfinite(v) and v > 0 for v in numbers) or not row["operations_share"] <= 1:
            failures.append(f"flops_count {mode}: rate or share out of range {numbers}")


def tools_dispersion(workdir: Path, report: dict, failures: list) -> None:
    """``dispersion_report_torch.py --rebuild`` on phase magnetoroton's directory:
    sector 2's row, its ED gap equal to the port's ED (1e-9), a finite purity."""
    dispersion = script_module("dispersion_report_torch")
    entries, lines = quiet(dispersion.main, [
        str(workdir / "roton"), "--rebuild", "--tail", str(ROTON_TAIL), "--nelec", "6",
        "--flux", "15", "--ground-energy", str(ANCHOR_ENERGY)])
    want = sector_gap_ed(6, 15, ROTON_SECTOR)
    rows = [e for e in entries if e["L"] == ROTON_SECTOR]
    report["dispersion_report"] = dict(lines=lines, entries=entries, gap_ed_from_ed=want)
    if not rows or abs(rows[0].get("gap_ed", math.nan) - want) > 1e-9 or not math.isfinite(rows[0]["purity"]):
        failures.append(f"dispersion_report: sector {ROTON_SECTOR} {rows} against gap_ed {want}")


def phase_tools(workdir: Path, smi: str) -> dict:
    """The measurement tools of scripts/ at full width; returns the launches of
    their main path (the step split and the trace).  Every tool runs even when
    one before it failed, and the phase's line reports them all."""
    import traceback

    device = torch.device("cuda", 0)
    start = time.perf_counter()
    failures: list = []
    report: dict = {"flops_count": {}}
    tools_counts: dict = {}

    def guarded(name: str, fn, *args) -> None:
        try:
            fn(*args, report, failures)
        except Exception:  # noqa: BLE001 - recorded and raised after the phase's line
            failures.append(f"{name}: {traceback.format_exc()[-1500:]}")

    reset_counts()
    guarded("profile", tools_profile)
    guarded("trace", tools_trace, workdir)
    tools_counts.update(launch_counts())
    guarded("benches", tools_benches, device)
    guarded("count", tools_count)
    guarded("dispersion", tools_dispersion, workdir)
    emit(phase="tools", nvidia_smi=smi, seconds=time.perf_counter() - start,
         launches=tools_counts, failures=failures, **report)
    for mode, row in report["flops_count"].items():
        print(f"tools: {mode} iteration {row['flops'] / 1e12:.4f} TFLOP counted, "
              f"{row['achieved_tflops']:.3f} TFLOP/s over {row['iteration_ms']:.2f} ms, least time "
              f"at the peaks {row['operations_ms']:.3f} ms = {100 * row['operations_share']:.2f}% "
              f"(unfused bytes {row['bytes_unfused_ms']:.2f} ms) on {smi}", flush=True)
    if failures:
        raise AssertionError(f"tools: {failures}")
    return tools_counts


def n10_argv(workdir: Path, device, optimizer: str, iterations: int, *extra: str) -> list[str]:
    """The training CLI on the N = 10 production state (its config and checkpoint)."""
    return ["--device", str(device), "--yml", str(N10 / "config.yml"),
            f"optim.optimizer={optimizer}", f"log.restore_path={N10_CKPT}",
            f"log.save_path={workdir}", f"optim.iterations={iterations}", *extra]


def history_numbers(history: list) -> dict:
    energies = np.array([row["energy"].real for row in history])
    step_times = [row["step_time"] for row in history]
    return dict(
        iterations=len(history),
        mean_energy=float(energies.mean()),
        energy_sem=float(energies.std(ddof=1) / math.sqrt(len(energies))),
        energies=energies.tolist(),
        mean_l_square=float(np.mean([row["angular_momentum_square"] for row in history])),
        l_squares=[row["angular_momentum_square"] for row in history],
        finite=bool(np.isfinite(energies).all()),
        step_time_median_ms=statistics.median(step_times) * 1e3,
    )


def counted_run(fn, *args) -> tuple:
    """``fn(*args)`` with the launch counters from 0 and the peak memory reset:
    its result, its counts, its seconds and its peak memory in GB."""
    reset_counts()
    torch.cuda.reset_peak_memory_stats()
    start = time.perf_counter()
    result = fn(*args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    return result, launch_counts(), wall, torch.cuda.max_memory_allocated() / 1e9


def large_n_paths(model, system, data) -> dict:
    """The local energy of ``data`` through the kernels, the plain versions and
    float64, with the gates of phases ``end_to_end`` and ``train``: the kernel
    path within END_TO_END_TOL of the plain path's RMS (batch mean and median
    walker), its mean within MEAN_SHIFT_SEM of float64's standard error, and
    no farther from float64 than ``float64_gate`` allows."""
    fields = training_agreement(training_paths(model, None, system, data))
    if not system.compute_l2:  # L^2 is NaN on every path
        del fields["angular_momentum_square"]
    bad = [k for k, v in fields.items()
           if not (v["kernels_vs_plain_mean_shift_rel"] <= END_TO_END_TOL
                   and v["kernels_vs_plain_median_dev_rel"] <= END_TO_END_TOL
                   and v["kernels_vs_float64_mean_shift_sem"] <= MEAN_SHIFT_SEM)]
    if system.compute_l2:
        bad += float64_gate(fields)
    else:
        bad += [k for k, v in fields.items()
                if not v["kernels_vs_float64_median_dev_rel"]
                <= MEDIAN_VS_PLAIN * v["plain_vs_float64_median_dev_rel"]]
    return dict(walkers=int(data.shape[0]), compute_l2=system.compute_l2, fields=fields, bad=bad)


def phase_large_n(workdir: Path, device, smi: str) -> tuple[dict, dict]:
    """Kernels and production states beyond N = 6; returns the kernel rows by
    shape and the launches of the phase's runs of the program.  Every part runs
    even when one before it failed, and the phase's line reports them all."""
    import traceback

    from deephall_tpu_torch import train
    from deephall_tpu_torch.log import LogManager

    rates = peaks(torch.cuda.get_device_name(0))
    start = time.perf_counter()
    failures: list = []
    report: dict = {"kernels": {}, "runs": {}, "paths": {}, "split": {}}
    kernels: dict = {}
    counts: dict = {}

    def guarded(name: str, fn, *args) -> None:
        try:
            fn(*args)
        except Exception:  # noqa: BLE001 - recorded and raised after the phase's line
            failures.append(f"{name}: {traceback.format_exc()[-1500:]}")

    def add_counts(run_counts: dict) -> None:
        for k, v in run_counts.items():
            counts[k] = counts.get(k, 0) + v

    def shape_rows(n: int, c: int, e: int):
        rows = kernel_rows(device, rates, c, e, tokens=n)
        kernels[f"N{n}C{c}E{e}"] = rows
        for key, row in rows.items():
            emit(phase="large_n_kernel", kernel=key, n=n, c=c, e=e, **row)

    def cli_run(name: str, iterations: int, optimizer: str, steps: int, *extra: str) -> None:
        save = workdir / "large_n" / name
        history, run_counts, wall, peak = counted_run(
            train.cli, n10_argv(save, device, optimizer, steps, *extra))
        add_counts(run_counts)
        expected = {k: iterations * v for k, v in launches_per_local_energy(production=False).items()}
        report["runs"][name] = dict(**history_numbers(history), wall_s=wall, peak_memory_gb=peak,
                                    launches=run_counts, expected_launches=expected)
        if len(history) != iterations or not report["runs"][name]["finite"]:
            raise AssertionError(f"{name}: {len(history)} iterations of {iterations}, or non-finite")
        if run_counts != expected:
            raise AssertionError(f"{name}: launch counts {run_counts} != expected {expected}")

    def n10_inference():
        cli_run("n10_inference", N10_ITERATIONS, "none", N10_ITERATIONS, "mcmc.burn_in=10")
        mean = report["runs"]["n10_inference"]["mean_energy"]
        if not abs(mean - N10_ENERGY) <= N10_TOL:
            raise AssertionError(f"n10_inference: mean energy {mean} not within {N10_TOL} of {N10_ENERGY}")

    def n10_l2():
        cli_run("n10_inference_l2", N10_L2_ITERATIONS, "none", N10_L2_ITERATIONS,
                "mcmc.burn_in=10", "system.compute_l2=true")
        l2 = report["runs"]["n10_inference_l2"]["mean_l_square"]
        if not l2 < N10_L2_MAX:
            raise AssertionError(f"n10_inference_l2: mean L^2 {l2} not < {N10_L2_MAX}")

    def n10_kfac():
        cli_run("n10_kfac", N10_KFAC_ITERATIONS, "kfac", N10_RESUME_STEP + N10_KFAC_ITERATIONS)
        run = report["runs"]["n10_kfac"]
        last = workdir / "large_n" / "n10_kfac" / f"ckpt_{N10_RESUME_STEP + N10_KFAC_ITERATIONS - 1:06d}.npz"
        _, final, _ = LogManager.restore_checkpoint(last)
        run["kfac_step_exit"] = int(final.opt_state.step)
        run["kfac_weight_exit"] = float(final.opt_state.weight)
        if run["kfac_step_exit"] != N10_RESUME_STEP + N10_KFAC_ITERATIONS:
            raise AssertionError(f"n10_kfac: KfacState step {run['kfac_step_exit']}: not the stored curvature")
        if not abs(run["mean_energy"] - N10_ENERGY) <= N10_KFAC_TOL:
            raise AssertionError(f"n10_kfac: mean energy {run['mean_energy']} not within {N10_KFAC_TOL}")

    def n10_paths():
        cfg, model, state = restored_model(N10_CKPT, device, N10 / "config.yml")
        model.requires_grad_(False)
        data = torch.as_tensor(state.data[:HESSIAN_WALKERS], device=device)
        for compute_l2 in (True, False):
            cfg.system.compute_l2 = compute_l2
            name = "n10_l2" if compute_l2 else "n10_lean"
            report["paths"][name] = large_n_paths(model, cfg.system, data)
            if report["paths"][name]["bad"]:
                raise AssertionError(f"paths {name}: off in {report['paths'][name]['bad']}")

    def n12_block():
        tools = script_module("torch_production_block")
        cfg, block, state, _, pmoves, t = tools.build_production_block(
            True, N12_ITERATIONS, device, nelec=N12_NELEC, flux=N12_FLUX)
        (state, _, _, stats, pmove), run_counts, wall, peak = counted_run(
            block, state, pmoves, t, N12_ITERATIONS)
        add_counts(run_counts)
        rows = train.host_rows(stats, pmove)
        for row in rows:
            row["step_time"] = wall / N12_ITERATIONS
        expected = {k: N12_ITERATIONS * v for k, v in launches_per_local_energy(production=False).items()}
        report["runs"]["n12_block"] = dict(**history_numbers(rows), wall_s=wall, peak_memory_gb=peak,
                                           launches=run_counts, expected_launches=expected)
        paths = large_n_paths(state.params, cfg.system, state.data)
        report["paths"]["n12_l2"] = paths
        if len(rows) != N12_ITERATIONS or not report["runs"]["n12_block"]["finite"]:
            raise AssertionError("n12_block: missing iterations or non-finite energy")
        if run_counts != expected:
            raise AssertionError(f"n12_block: launch counts {run_counts} != expected {expected}")
        if paths["bad"]:
            raise AssertionError(f"n12_block: the kernel path is off in {paths['bad']}")

    def n10_split():
        """``torch_profile_step.py`` at N = 10, 2Q = 27 in both modes (a fresh
        production Psiformer) under :func:`profile_parts`, every LayerNorm staged."""
        for mode, flags in (("l2", []), ("lean", ["--fast"])):
            parts, lines, problems = profile_parts(["--nelec", "10", "--flux", "27", *flags],
                                                   launches_per_local_energy(production=False))
            report["split"][mode] = dict(
                lines=lines, **{f"{k}_ms": parts[k]["ms"] for k in SPLIT_PARTS},
                local_energy_launches=parts["local_energy"]["launches"])
            if problems:
                raise AssertionError(f"split {mode}: {problems}")
            torch.cuda.empty_cache()

    for n, c, e in LARGE_N_SHAPES:
        guarded(f"kernels N{n}C{c}E{e}", shape_rows, n, c, e)
    report["kernels"] = {key: {k: {f: row[f] for f in LARGE_N_FIELDS if f in row}
                               for k, row in rows.items()} for key, rows in kernels.items()}
    guarded("n10_inference", n10_inference)
    guarded("n10_inference_l2", n10_l2)
    guarded("n10_kfac", n10_kfac)
    guarded("n10_paths", n10_paths)
    guarded("n12_block", n12_block)
    guarded("n10_split", n10_split)
    emit(phase="large_n", nvidia_smi=smi, seconds=time.perf_counter() - start, batch=BATCH,
         launches=counts, failures=failures, **report)
    for mode, split in report["split"].items():
        print(f"large_n: N=10 {mode} split, ms: " + ", ".join(
            f"{k} {split[f'{k}_ms']:.2f}" for k in SPLIT_PARTS) + f" on {smi}", flush=True)
    for name, run in report["runs"].items():
        print(f"large_n: {name} {run['iterations']} iterations, mean energy {run['mean_energy']:.5f} "
              f"+- {run['energy_sem']:.5f}, L^2 {run['mean_l_square']:.4f}, "
              f"{run['step_time_median_ms']:.1f} ms an iteration, peak {run['peak_memory_gb']:.2f} GB "
              f"on {smi}", flush=True)
    if failures:
        raise AssertionError(f"large_n: {failures}")
    return kernels, counts


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--rank-child":
        return rank_child(sys.argv[2], sys.argv[3:])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from deephall_tpu_torch import train  # noqa: F401  (switches TF32 off)
    from deephall_tpu_torch.ops import _build

    device = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    emit(
        phase="environment", torch=torch.__version__, cuda=torch.version.cuda,
        device=name, count=torch.cuda.device_count(), nvidia_smi=smi,
        tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        tf32_cudnn=torch.backends.cudnn.allow_tf32,
    )
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise AssertionError("TF32 is on")
    rates = peaks(name)

    start = time.perf_counter()
    libraries = _build.build()
    ptxas = {
        lib: [line.strip() for line in Path(f"{path}.log").read_text().splitlines()
              if "Compiling entry" in line or "registers" in line or "spill" in line
              or "Potential Performance Loss" in line]
        for lib, path in libraries.items() if Path(f"{path}.log").exists()
    }
    emit(phase="build", seconds=time.perf_counter() - start, libraries=sorted(libraries), ptxas=ptxas)
    spilled = spills(ptxas["jet_layernorm"], "jet_layernorm_staged_kernel")
    spilled += spills(ptxas["jet_attention"], "jet_softmax_values_streamed_kernel")
    if spilled:
        raise AssertionError(f"build: a kernel spills: {spilled}")

    kernels = phase_kernels(device, rates)
    orbital_rows = phase_orbital_head(device, rates)
    gram_rows = phase_kfac_gram(device, rates)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        counts = phase_slice(Path(workdir))
        phase_slice_excited(Path(workdir))
        phase_end_to_end(device)
        pole_counts = phase_psiformer_pole(device)
        train_counts, train_history, train_gram_launches = phase_train(Path(workdir), device)
        excited_counts = phase_excited(Path(workdir))
        start = time.perf_counter()
        phase_laughlin(Path(workdir), device)
        hessian_counts = phase_hessian(device)
        phase_ed_state(device)
        emit(phase="slice_6_phases", seconds=time.perf_counter() - start)
        phase_observables(Path(workdir),
                          Path(workdir) / "laughlin" / f"ckpt_{LAUGHLIN_ITERATIONS - 1:06d}.npz", smi)
        phase_distributed(Path(workdir), train_history, train_counts, smi)
        trace_counts = phase_trace(Path(workdir), smi)
        roton_counts = phase_magnetoroton(Path(workdir), smi)
        tools_counts = phase_tools(Path(workdir), smi)
        large_kernels, large_counts = phase_large_n(Path(workdir), device, smi)

    sources = {
        "jet_layernorm": ("deephall_tpu_torch/csrc/jet_layernorm.cu", "deephall_tpu/ops/jet_layernorm.py:58"),
        "jet_attention": ("deephall_tpu_torch/csrc/jet_attention.cu", "deephall_tpu/ops/jet_attention.py:93"),
        "jet_gemm": ("deephall_tpu_torch/csrc/jet_attention.cu", "deephall_tpu/ops/jet_attention.py:116"),
        "jet_softmax_values": ("deephall_tpu_torch/csrc/jet_attention.cu", "deephall_tpu/ops/jet_attention.py:142"),
    }
    table = []
    for kernel, (source, replaces) in sources.items():
        mode = f"C{MODES[0][0]}E{MODES[0][1]}"
        row = dict(name=kernel, route="cuda", source=source, replaces=replaces,
                   launches=counts[kernel], launches_train=train_counts[kernel],
                   launches_excited=excited_counts[kernel],
                   launches_hessian=hessian_counts[kernel],
                   launches_psiformer_pole=pole_counts[kernel],
                   launches_trace=trace_counts[kernel],
                   launches_magnetoroton=roton_counts[kernel],
                   launches_tools=tools_counts[kernel],
                   launches_large_n=large_counts[kernel],
                   **table_numbers(kernels[(kernel, mode)]))
        # The same kernel beyond N = 6 (phase large_n), by shape.
        row["large_n"] = {shape: table_numbers(rows[kernel]) for shape, rows in large_kernels.items()}
        if kernel == "jet_layernorm":
            row["launches_streamed"] = counts["jet_layernorm_streamed"]
            row["launches_staged"] = counts["jet_layernorm_staged"]
            row["launches_staged_large_n"] = large_counts["jet_layernorm_staged"]
        if kernel == "jet_gemm":
            # The q/k/v projection (N = 3D) above; the output projection (N = D) here.
            row["launches_tensor_core"] = counts["jet_gemm_tensor_core"]
            row["out_projection"] = table_numbers(kernels[("jet_gemm_out", mode)])
        if kernel == "jet_softmax_values":
            row["launches_tiled"] = counts["jet_softmax_values_tiled"]
        table.append(row)
    # The staged LayerNorm, which takes every launch beyond N = 6: its own row,
    # at N = 10 with L^2 and a residual, with its launches in phase large_n.
    staged = large_kernels["N10C23E3"]["jet_layernorm"]
    table.append(dict(name="jet_layernorm_staged", route="cuda", source=sources["jet_layernorm"][0],
                      replaces=sources["jet_layernorm"][1], shape="N10C23E3",
                      launches=large_counts["jet_layernorm_staged"], **table_numbers(staged)))
    # The streamed softmax/values kernel, which takes every attention launch
    # beyond N = 6: its own row at N = 10 with L^2, its launches in phase large_n.
    streamed = large_kernels["N10C23E3"]["jet_softmax_values"]
    table.append(dict(name="jet_softmax_values_streamed", route="cuda",
                      source=sources["jet_softmax_values"][0], replaces=sources["jet_softmax_values"][1],
                      shape="N10C23E3",
                      launches=large_counts["jet_softmax_values"] - large_counts["jet_softmax_values_tiled"],
                      **table_numbers(streamed)))
    # The orbital head's kernel (no TPU kernel: the JAX package leaves the head
    # to XLA): its rows at the four configurations, its launches in phase large_n.
    table.append(dict(name="orbital_head_jet", route="cuda",
                      source="deephall_tpu_torch/csrc/orbital_head.cu",
                      replaces="deephall_tpu/networks/fwdlap.py:psiformer_logpsi_jet's orbital head (XLA)",
                      launches=counts["orbital_head"], launches_large_n=large_counts["orbital_head"],
                      shapes={name: table_numbers(row) for name, row in orbital_rows.items()}))
    # KFAC's Gram products (no TPU kernel: the JAX package leaves a.T @ a to XLA):
    # their rows at the two shapes, their launches in phase train's CLI run.
    table.append(dict(name="kfac_gram", route="cuda", source="deephall_tpu_torch/csrc/kfac_gram.cu",
                      replaces="deephall_tpu/optimizers/kfac.py:171-172's a.T @ a and g.T @ g (XLA)",
                      launches_train=train_gram_launches,
                      shapes={name: table_numbers(row) for name, row in gram_rows.items()}))
    print(smi, flush=True)
    emit(kernels=table)
    emit(ok=True, device={"platform": "gpu", "kind": name, "count": torch.cuda.device_count()})
    return 0


if __name__ == "__main__":
    sys.exit(main())
