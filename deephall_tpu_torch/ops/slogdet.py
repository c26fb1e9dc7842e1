"""Complex determinants from one LU factorisation (port of ``deephall_tpu/ops/slogdet.py``).

The JAX package carries its own split-real, gather-free elimination because the
TPU has no complex LU.  Here ``torch.linalg.lu_factor_ex`` factors the complex
batch directly (cuBLAS / cuSOLVER on the card, LAPACK on the CPU), and the
sign and log-magnitude are read off the LU diagonal and the pivot parity, so a
determinant and its solves share a single factorisation.
"""

from __future__ import annotations

import torch


def _slogdet_from_lu(lu: torch.Tensor, pivots: torch.Tensor):
    n = lu.shape[-1]
    diag = torch.diagonal(lu, dim1=-2, dim2=-1)
    rows = torch.arange(1, n + 1, device=pivots.device, dtype=pivots.dtype)
    swaps = (pivots != rows).sum(dim=-1)
    parity = 1.0 - 2.0 * (swaps % 2).to(lu.real.dtype)
    absdiag = torch.abs(diag)
    logabs = torch.log(absdiag).sum(dim=-1)
    if lu.is_complex():
        phase = torch.prod(diag / absdiag, dim=-1)
        return parity * phase, logabs
    return parity * torch.prod(torch.sign(diag), dim=-1), logabs


def slogdet(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign (unit phase) and log-magnitude of ``det(a)``; leading axes are batch axes."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)
    return _slogdet_from_lu(lu, pivots)


def slogdet_solve(
    a: torch.Tensor, b: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``(sign, log|det a|, a^-1 b)`` from a single LU factorisation; ``b``: ``[*, n, k]``."""
    lu, pivots, _ = torch.linalg.lu_factor_ex(a)
    sign, logabs = _slogdet_from_lu(lu, pivots)
    return sign, logabs, torch.linalg.lu_solve(lu, pivots, b.to(lu.dtype))


def signed_logsumdet(orbitals: torch.Tensor) -> torch.Tensor:
    """Complex ``log sum_d det(orbitals_d)`` over the determinant axis ``-3``.

    ``orbitals``: ``[..., ndet, nelec, nelec]``; a bare ``[nelec, nelec]`` is one
    determinant.  The sum uses the log-sum-exp shift for stability.
    """
    if orbitals.ndim == 2:
        orbitals = orbitals[None]
    signs, logdets = slogdet(orbitals)  # [..., ndet]
    logmax = torch.amax(logdets, dim=-1, keepdim=True)
    return (
        torch.log(torch.sum(signs * torch.exp(logdets - logmax), dim=-1))
        + logmax[..., 0]
    )
