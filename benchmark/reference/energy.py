"""Local energy and angular momenta of electrons on the monopole sphere, by
the full Hessian of log psi taken with nested autograd.

Haldane's sphere of radius ``r = sqrt(Q)`` (``Q`` half the flux) in the
symmetric gauge, walkers ``(theta, phi)`` per electron.  With ``g`` and ``h``
the complex gradient and Hessian of ``log psi`` in ``(theta, phi)``:

    KE  = -1/(2 r^2) sum_i [ g_t/tan t + h_tt + g_t^2 + (h_pp + (g_p - iQ cos t)^2) / sin^2 t ]
    Lz  = sum_i Im g_p,   Lz^2 = -Re sum_ij (h_pp + g_p g_p)
    L^2 = sum over electron pairs of the products of the components of
          L_i = -i (phi_hat d_t - theta_hat' d_p) + Q (theta_hat' cos t + r_hat)

(``theta_hat' = (cos phi / tan t, sin phi / tan t, -1)``), the Coulomb
energy ``sum_{i<j} 1 / (r |x_i - x_j|)``.  Every walker's Hessian is
``[2N, 2N]``, from one second backward pass over 4N copies of the walkers.
"""

from __future__ import annotations

import math

import torch


def _hessian(logpsi_fn, x):
    """``(log psi, gradient [B, N, 2], Hessian [B, N, 2, N, 2])``, complex.

    The walkers are copied once for each of the 4N rows of the real and
    imaginary Hessians; each copy's gradient is differentiated along its own
    row, so that one second backward pass over the copies gives every row."""
    b, n = x.shape[0], x.shape[-2]
    dims = 2 * n
    copies = x.detach().repeat(2 * dims, 1, 1).requires_grad_(True)
    with torch.enable_grad():
        f = logpsi_fn(copies)
        g_re, = torch.autograd.grad(f.real.sum(), copies, create_graph=True)
        g_im, = torch.autograd.grad(f.imag.sum(), copies, create_graph=True)
        rows = torch.arange(dims, device=x.device)
        pick_re = g_re.reshape(2 * dims, b, dims)[rows, :, rows]
        pick_im = g_im.reshape(2 * dims, b, dims)[dims + rows, :, rows]
        hess, = torch.autograd.grad(pick_re.sum() + pick_im.sum(), copies)
    hess = hess.reshape(2, dims, b, dims)
    hess = torch.complex(hess[0], hess[1]).permute(1, 0, 2).reshape(b, n, 2, n, 2)
    grad = torch.complex(g_re[:b], g_im[:b]).detach()
    return f[:b].detach(), grad, hess


def observables(logpsi_fn, x: torch.Tensor, flux: int, strength: float = 1.0) -> dict:
    """Per-walker ``energy`` (complex), ``kinetic`` (complex), ``potential``,
    ``angular_momentum_z``, ``angular_momentum_z_square``,
    ``angular_momentum_square`` and ``logpsi`` of the walkers ``x [B, N, 2]``."""
    q = flux / 2
    r = math.sqrt(q)
    f, grad, hess = _hessian(logpsi_fn, x)
    theta, phi = x[..., 0], x[..., 1]
    sin_t, cos_t, tan_t = torch.sin(theta), torch.cos(theta), torch.tan(theta)
    g_t, g_p = grad[..., 0], grad[..., 1]
    h_tt, h_tp, h_pp = hess[:, :, 0, :, 0], hess[:, :, 0, :, 1], hess[:, :, 1, :, 1]
    diag = lambda m: torch.diagonal(m, dim1=-2, dim2=-1)  # noqa: E731
    polar = (diag(h_pp) + (g_p - 1j * q * cos_t) ** 2) / sin_t**2
    kinetic = -(g_t / tan_t + diag(h_tt) + g_t**2 + polar).sum(-1) / (2 * r**2)

    col = lambda v: v[..., :, None]  # noqa: E731
    row = lambda v: v[..., None, :]  # noqa: E731
    psi_tt = h_tt + col(g_t) * row(g_t)
    psi_tp = h_tp + col(g_t) * row(g_p)
    psi_pp = h_pp + col(g_p) * row(g_p)
    r_hat = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], dim=1)
    phi_hat = torch.stack([-torch.sin(phi), torch.cos(phi), torch.zeros_like(phi)], dim=1)
    theta_hat = torch.stack([torch.cos(phi) / tan_t, torch.sin(phi) / tan_t,
                             -torch.ones_like(phi)], dim=1)  # [B, 3, N]
    mag = q * (theta_hat * cos_t[:, None] + r_hat)
    pairs = (2 * col(phi_hat) * row(theta_hat) * psi_tp[:, None]
             - col(phi_hat) * row(phi_hat) * psi_tt[:, None]
             - col(theta_hat) * row(theta_hat) * psi_pp[:, None]
             - 2j * row(mag) * (col(phi_hat) * col(g_t[:, None]) - col(theta_hat) * col(g_p[:, None]))
             + col(mag) * row(mag)).sum(1)  # [B, N, N]
    off = 1 - torch.eye(x.shape[-2], dtype=x.dtype, device=x.device)
    l_square = ((pairs * off).sum((-2, -1)) + (q**2 - diag(psi_tt) - polar).sum(-1)
                - (g_t / tan_t).sum(-1)).real

    xyz = r_hat.transpose(1, 2)
    i, j = torch.triu_indices(x.shape[-2], x.shape[-2], 1, device=x.device)
    potential = (1 / torch.sqrt(((xyz[:, i] - xyz[:, j]) ** 2).sum(-1))).sum(-1) / r * strength
    return {
        "energy": kinetic + potential,
        "kinetic": kinetic,
        "potential": potential,
        "angular_momentum_z": g_p.imag.sum(-1),
        "angular_momentum_z_square": -psi_pp.real.sum((-2, -1)),
        "angular_momentum_square": l_square,
        "logpsi": f,
    }


def observables_in_blocks(logpsi_fn, x: torch.Tensor, flux: int, rows: int, **kwargs) -> dict:
    """:func:`observables` over ``rows`` walkers at a time."""
    parts = [observables(logpsi_fn, x[s:s + rows], flux, **kwargs) for s in range(0, x.shape[0], rows)]
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
