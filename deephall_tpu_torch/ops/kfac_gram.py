"""KFAC's Kronecker factors ``x^T x / rows``: hand-written CUDA kernel and plain version.

Each Kronecker block's factors are Gram products of a layer's captured inputs
(with a ones column for a bias) and of its output sensitivities, over every
row of the batch.  :func:`gram` launches ``csrc/kfac_gram.cu:kfac_gram_kernel``
for CUDA tensors: three TF32 products on the tensor cores (float32 accuracy),
only the tiles on and above the diagonal, each value written at ``(i, j)`` and
``(j, i)``, so the result is exactly symmetric.  The ones column is never
formed: its row and column are the column sums of ``x``, which the kernel adds
beside the products, so ``x`` is read in place and never copied.  Where the
triangle has fewer tiles than the card has SMs, :func:`plan` splits the rows
into chunks and a finishing kernel adds them in a fixed order.  What the
kernel does not take raises.  CPU tensors take :func:`gram_plain`.  Each call
on the card is counted in ``gram.launches`` and as ``kfac.gram`` in the open
block record (:func:`deephall_tpu_torch.tracing.count`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from deephall_tpu_torch import tracing
from deephall_tpu_torch.ops._build import check, function, stream

TILE = 128  # the kernel's square output tile
STEP = 32  # rows of x a step
MIN_CHUNK_STEPS = 8  # the fewest steps a chunk of rows takes


class Plan(NamedTuple):
    """The kernel's work: ``tiles`` tiles of :data:`TILE` on and above the
    diagonal, the rows in ``chunks`` chunks of ``chunk_steps`` steps of
    :data:`STEP` rows."""

    tiles: int
    chunks: int
    chunk_steps: int


def plan(rows: int, n_in: int, sms: int) -> Plan:
    """The tiles of ``x^T x`` (``x: [rows, n_in]``) and the chunks of rows that
    fill ``sms`` SMs: with as many tiles as SMs or more the rows are one
    chunk; with fewer, as many chunks as put a tile on every SM, each of
    :data:`MIN_CHUNK_STEPS` steps at least.  The ones column adds no tile."""
    blocks = -(-n_in // TILE)
    tiles = blocks * (blocks + 1) // 2
    steps = -(-rows // STEP)
    chunks = 1 if tiles >= sms else max(1, min(sms // tiles, steps // MIN_CHUNK_STEPS))
    chunk_steps = -(-steps // chunks)
    return Plan(tiles, -(-steps // chunk_steps), chunk_steps)


def gram_plain(x: torch.Tensor, ones_column: bool = False) -> torch.Tensor:
    """``[x 1]^T [x 1] / rows`` (the ones column where ``ones_column``), as
    ``torch.matmul`` computes it."""
    rows = x.shape[0]
    if ones_column:
        x = torch.cat([x, torch.ones((rows, 1), dtype=x.dtype, device=x.device)], -1)
    return (x.T @ x) / rows


@functools.cache
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_PTR = ctypes.c_void_p
_ARGTYPES = (_PTR, ctypes.c_int64, ctypes.c_int64) + (ctypes.c_int,) * 7 + (_PTR, _PTR, _PTR)


def gram(x: torch.Tensor, ones_column: bool = False) -> torch.Tensor:
    """``[x 1]^T [x 1] / rows`` of ``x: [rows, n_in]`` float32, ``[n, n]`` with
    ``n = n_in + ones_column``.  CPU tensors take :func:`gram_plain`; CUDA
    tensors take the kernel, which reads ``x`` in place at its strides and
    raises a ``TypeError`` / ``ValueError`` naming what it does not take."""
    if x.device.type == "cpu":
        return gram_plain(x, ones_column)
    if x.dtype != torch.float32 or x.dim() != 2:
        raise TypeError(f"gram: need a float32 matrix, got {x.dtype} of shape {tuple(x.shape)}")
    rows, n_in = x.shape
    if rows == 0 or n_in == 0:
        raise ValueError(f"gram: need rows and columns, got shape {tuple(x.shape)}")
    if rows >= 1 << 24:
        raise ValueError(f"gram: {rows} rows; float32 counts them exactly below 2^24")
    sms = _sms(x.device.index if x.device.index is not None else torch.cuda.current_device())
    work = plan(rows, n_in, sms)
    n = n_in + int(ones_column)
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    scratch = (torch.empty((work.chunks, n, n), dtype=torch.float32, device=x.device)
               if work.chunks > 1 else None)
    status = function("kfac_gram", "kfac_gram_f32", _ARGTYPES)(
        x.data_ptr(), x.stride(0), x.stride(1), rows, n_in, int(ones_column), *work, sms,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(), stream(x.device))
    check(status, "kfac_gram")
    gram.launches += 1
    tracing.count("kfac.gram")
    return out


gram.launches = 0
