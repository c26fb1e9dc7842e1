"""Complex determinants from one LU factorisation (port of ``deephall_tpu/ops/slogdet.py``).

The JAX package carries its own split-real, gather-free elimination because the
TPU has no complex LU.  Here ``torch.linalg.lu_factor_ex`` factors the complex
batch directly (cuBLAS / cuSOLVER on the card, LAPACK on the CPU), and the
sign and log-magnitude are read off the LU diagonal and the pivot parity, so a
determinant and its solves share a single factorisation
(:func:`slogdet_solve`, forward-only, as in the JAX package).

:func:`slogdet` is the differentiable one: the gradient, the KFAC capture and
the full-Hessian local energy (``hamiltonian.local_energy``, a second
derivative) go through it.
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
    """``(sign, log|det a|)`` whose derivative rules are differentiable
    operations on ``a``, so that it can be differentiated to any order, under
    autograd and under ``torch.func``, as the JAX package's custom JVP
    (``deephall_tpu/ops/slogdet.py:slogdet``) can.

    Forward mode: ``d log det A = tr(A^-1 dA)``, so ``d log|det| = Re tr`` and,
    for complex ``A``, ``d sign = i Im(tr) sign``; a real sign is piecewise
    constant.  Reverse mode, for a real loss: the cotangent of the complex
    ``log det`` is ``c = g_logabs + i Im(g_sign conj(sign))`` (``g_logabs`` for
    real ``A``) and the gradient is ``c A^-H``.  ``A^-1`` is
    ``torch.linalg.inv_ex`` of the saved input, which differentiates again and
    skips ``torch.linalg.inv``'s error check (a host read).

    The backward does not reuse the forward's LU even for a first derivative:
    grad mode does not tell whether it will be differentiated (the loss takes
    the full-Hessian local energy under ``torch.no_grad``, which ``torch.func``
    overrides).  ``torch.linalg.slogdet`` is not used: in torch 2.13.0 (CPU)
    its rules give wrong tangents under ``vmap`` of ``jacfwd``
    (``tests/test_torch_slogdet.py::test_vmap_over_a_batch``).
    ``generate_vmap_rule`` fails inside ``jacfwd``; every operation here takes
    leading batch axes, so the batching rule moves the batch axis to the front.
    """

    @staticmethod
    def forward(a):
        return torch.linalg.slogdet(a)

    @staticmethod
    def setup_context(ctx, inputs, output):
        (a,) = inputs
        sign, _ = output
        ctx.save_for_backward(a, sign)
        ctx.save_for_forward(a, sign)

    @staticmethod
    def backward(ctx, g_sign, g_logabs):
        a, sign = ctx.saved_tensors
        c = g_logabs
        if a.is_complex():
            c = torch.complex(g_logabs, (g_sign * sign.conj()).imag)
        return c[..., None, None] * torch.linalg.inv_ex(a).inverse.mH

    @staticmethod
    def jvp(ctx, a_dot):
        a, sign = ctx.saved_tensors
        trace = (torch.linalg.inv_ex(a).inverse * a_dot.mT).sum(dim=(-2, -1))
        if a.is_complex():
            return 1j * trace.imag * sign, trace.real
        return torch.zeros_like(sign), trace

    @staticmethod
    def vmap(info, in_dims, a):
        del info
        return _Slogdet.apply(a.movedim(in_dims[0], 0)), (0, 0)


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
