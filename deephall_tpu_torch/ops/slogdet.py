"""Complex determinants from one LU factorisation (port of ``deephall_tpu/ops/slogdet.py``).

The JAX package carries its own split-real, gather-free elimination because the
TPU has no complex LU.  Here ``torch.linalg.lu_factor_ex`` factors the complex
batch directly (cuBLAS / cuSOLVER on the card, LAPACK on the CPU), and the
sign and log-magnitude are read off the LU diagonal and the pivot parity, so a
determinant and its solves share a single factorisation.

:func:`slogdet` has a gradient, the JAX package's custom JVP
``d log det A = tr(A^-1 dA)`` read backwards: its backward reuses the
forward's LU for ``A^-H``, so neither the pivots nor the ``diag / |diag|``
phase product are differentiated.  :func:`slogdet_solve` stays forward-only,
as in the JAX package.
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


class _Slogdet(torch.autograd.Function):
    """``(sign, log|det a|)`` with the backward of ``log det a = log|det a| + i arg``.

    For a real loss ``L``, the cotangent of the complex ``log det`` is
    ``c = dL/dlog|det| + i dL/darg`` with ``dL/darg = Im(g_sign conj(sign))``
    (``d sign = i sign d arg``), and since ``log det`` is holomorphic with
    derivative ``A^-T``, the gradient is ``c A^-H``.  For real ``a`` the sign
    is piecewise constant and the gradient is ``g_logabs A^-T``.
    """

    @staticmethod
    def forward(ctx, a):
        lu, pivots, _ = torch.linalg.lu_factor_ex(a)
        sign, logabs = _slogdet_from_lu(lu, pivots)
        ctx.save_for_backward(lu, pivots, sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, g_sign, g_logabs):
        lu, pivots, sign = ctx.saved_tensors
        eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device).expand(lu.shape)
        inv_h = torch.linalg.lu_solve(lu, pivots, eye, adjoint=True)  # A^-H
        c = g_logabs
        if lu.is_complex():
            c = torch.complex(g_logabs, (g_sign * sign.conj()).imag)
        return c[..., None, None] * inv_h


def slogdet(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sign (unit phase) and log-magnitude of ``det(a)``; leading axes are batch axes."""
    return _Slogdet.apply(a)


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
