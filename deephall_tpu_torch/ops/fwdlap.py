"""Forward-Laplacian jet propagation (port of ``deephall_tpu/ops/fwdlap.py``).

Every intermediate activation carries a second-order jet:

* ``x`` — the primal value ``[*S]``;
* ``j`` — ``K+E`` directional first derivatives ``[K+E, *S]``: the ``K = 2N``
  Laplacian directions, then the ``E`` extra directions;
* ``l`` — the second derivative summed over the ``K`` Laplacian directions;
* ``d`` — ``E`` second derivatives, one per extra direction (row 0 the
  rotation about z, rows 1-2 the rotations about x and y when present).

The directions are curves on the sphere (:func:`electron_seeds`): unit-speed
great circles through each electron along ``e_theta`` and ``e_phi``, whose
second derivatives sum to the Laplace-Beltrami operator, and rotations of
every electron about an axis.  Both are smooth at the poles.

The rules compose from linear maps, pointwise functions (with their first and
second derivatives written out, e.g. :func:`tanh`), bilinear contractions
(product rule plus a cross term over the Laplacian tangents) and closed-form
input functions (:func:`jet_of_fn`).  Determinants get their own rule on one LU
factorisation (:func:`logsumdet_jet`):

    d   log det A = tr(A^-1 dA)
    d^2 log det A = tr(A^-1 d^2 A) - tr((A^-1 dA)^2)
"""

from __future__ import annotations

from collections.abc import Callable
from typing import NamedTuple

import torch

from deephall_tpu_torch.ops.slogdet import slogdet_solve


class Jet(NamedTuple):
    """Second-order jet of an intermediate value; see the module docstring."""

    x: torch.Tensor  # [*S] primal
    j: torch.Tensor  # [K+E, *S] directional first derivatives
    l: torch.Tensor  # [*S] summed second derivative over the K Laplacian dirs
    d: torch.Tensor  # [E, *S] second derivatives along the extra directions

    @property
    def extras(self) -> int:
        return self.d.shape[0]

    @property
    def j_lap(self) -> torch.Tensor:
        return self.j[: self.j.shape[0] - self.extras]

    @property
    def j_extra(self) -> torch.Tensor:
        return self.j[self.j.shape[0] - self.extras :]


def add(a: Jet, b: Jet) -> Jet:
    """Jet of ``a + b``."""
    return Jet(a.x + b.x, a.j + b.j, a.l + b.l, a.d + b.d)


def shift(t: Jet, c) -> Jet:
    """Jet of ``x + c`` for a constant ``c``."""
    return Jet(t.x + c, t.j, t.l, t.d)


def linear(f: Callable[[torch.Tensor], torch.Tensor], t: Jet, bias=None) -> Jet:
    """Jet of a linear map ``f`` acting on trailing axes only."""
    x = f(t.x)
    if bias is not None:
        x = x + bias
    return Jet(x, f(t.j), f(t.l), f(t.d))


# Pointwise functions as (value, first, second) derivative rules, in place of
# the JAX package's nested ``jax.jvp``.  ``exp`` and ``log`` are holomorphic
# and take complex inputs.


def tanh(x):
    y = torch.tanh(x)
    f1 = 1 - y * y
    return y, f1, -2 * y * f1


def exp(x):
    y = torch.exp(x)
    return y, y, y


def reciprocal(x):
    r = 1 / x
    r2 = r * r
    return r, -r2, 2 * r2 * r


def log(x):
    r = 1 / x
    return torch.log(x), r, -r * r


def square(x):
    return x * x, 2 * x, torch.full_like(x, 2)


def rsqrt_eps(eps: float):
    """``v -> rsqrt(v + eps)`` with ``f1 = -rs^3/2`` and ``f2 = 3 rs^5 / 4``."""

    def rule(x):
        rs = torch.rsqrt(x + eps)
        rs3 = rs * rs * rs
        return rs, -0.5 * rs3, 0.75 * rs3 * rs * rs

    return rule


def elementwise(rule: Callable, t: Jet) -> Jet:
    """Jet of a pointwise function given by ``rule(x) -> (f(x), f'(x), f''(x))``."""
    x, f1, f2 = rule(t.x)
    jsq = torch.sum(torch.square(t.j_lap), dim=0)
    return Jet(
        x,
        f1 * t.j,
        f1 * t.l + f2 * jsq,
        f1 * t.d + f2 * torch.square(t.j_extra),
    )


def bilinear(f: Callable[[torch.Tensor, torch.Tensor], torch.Tensor], a: Jet, b: Jet) -> Jet:
    """Jet of a bilinear contraction ``f(a, b)`` (product rule + tangent cross term).

    ``f`` must broadcast over leading axes (``...`` einsums or elementwise
    arithmetic on trailing axes).
    """
    x = f(a.x, b.x)
    j = f(a.j, b.x[None]) + f(a.x[None], b.j)
    cross = f(a.j_lap, b.j_lap)
    l = f(a.l, b.x) + f(a.x, b.l) + 2 * torch.sum(cross, dim=0)
    d = f(a.d, b.x[None]) + f(a.x[None], b.d) + 2 * f(a.j_extra, b.j_extra)
    return Jet(x, j, l, d)


class Seeds(NamedTuple):
    """The seed curves: each electron's point, and its Cartesian velocity and
    acceleration along each curve."""

    x: torch.Tensor  # [*B, N, 3] unit vectors
    v: torch.Tensor  # [K+E, *B, N, 3]
    a: torch.Tensor  # [K+E, *B, N, 3]


def jet_of_fn(
    fn: Callable[[torch.Tensor, Seeds], tuple[torch.Tensor, torch.Tensor, torch.Tensor]],
    x: torch.Tensor,
    seeds: Seeds,
    extras: int,
) -> Jet:
    """Seed a jet through a closed-form function of the configuration.

    The JAX package takes nested ``jax.jvp`` along straight lines in
    ``(theta, phi)`` here.  The port's input functions (input features,
    monopole envelope, Jastrow) instead return their exact derivatives along
    the seed curves: ``fn(x, seeds) -> (f(x), D f(x), D^2 f(x))`` with one
    leading row per seed, where ``D^2`` is the second derivative along the
    curve (the coordinate one plus the curve's acceleration term).

    Args:
        fn: Closed-form function and its derivatives along the curves.
        x: ``[*B, N, 2]`` configurations.
        seeds: :class:`Seeds` of ``K+E`` curves (Laplacian first, extras last).
        extras: Number of extra directions E.
    """
    value, first, second = fn(x, seeds)
    k = seeds.v.shape[0] - extras
    return Jet(value, first, torch.sum(second[:k], dim=0), second[k:])


def hemisphere(theta: torch.Tensor) -> torch.Tensor:
    """``s = sign(cos theta)``, +1 on the equator: the pole at which each
    electron's gauge is regular (``networks/fwdlap.py:envelope_fn``)."""
    return torch.where(torch.cos(theta) >= 0, 1.0, -1.0).to(theta.dtype)


def electron_seeds(data: torch.Tensor, compute_l2: bool = False) -> Seeds:
    """Seed curves: unit geodesics for the Laplacian, rotations for Lz and L^2.

    Directions ``k = 2i`` and ``2i + 1`` move electron ``i`` alone along the
    great circles through it tangent to ``e_theta_i`` and ``e_phi_i`` (velocity
    the unit vector, acceleration ``-X_i``); the Laplace-Beltrami operator is
    the sum of the two second derivatives.  Extra direction 0 rotates every
    electron about z (velocity ``z x X``, acceleration ``z x (z x X)``); with
    ``compute_l2`` directions 1 and 2 rotate about x and about y.

    Returns:
        :class:`Seeds` with ``[2N+E, *B, N, 3]`` curves (``E = 3`` with
        ``compute_l2`` else 1).
    """
    theta, phi = data[..., 0], data[..., 1]
    st, ct, sp, cp = torch.sin(theta), torch.cos(theta), torch.sin(phi), torch.cos(phi)
    x = torch.stack([st * cp, st * sp, ct], dim=-1)
    # e_phi has no 1/sin(theta): at a pole the two still form an orthonormal frame.
    e_theta = torch.stack([ct * cp, ct * sp, -st], dim=-1)
    e_phi = torch.stack([-sp, cp, torch.zeros_like(sp)], dim=-1)
    n = data.shape[-2]
    eye = torch.eye(n, dtype=data.dtype, device=data.device)
    eye = eye.reshape((n,) + (1,) * (data.ndim - 2) + (n, 1))
    lap_v = torch.stack([eye * e_theta, eye * e_phi], dim=1).flatten(0, 1)
    lap_a = (-eye * x).repeat_interleave(2, dim=0)
    cx, cy, cz = x.unbind(-1)
    zero = torch.zeros_like(cx)
    rot_v = [torch.stack([-cy, cx, zero], dim=-1)]
    rot_a = [torch.stack([-cx, -cy, zero], dim=-1)]
    if compute_l2:
        rot_v += [torch.stack([zero, -cz, cy], dim=-1), torch.stack([cz, zero, -cx], dim=-1)]
        rot_a += [torch.stack([zero, -cy, -cz], dim=-1), torch.stack([-cx, zero, -cz], dim=-1)]
    return Seeds(x, torch.cat([lap_v, torch.stack(rot_v)]),
                 torch.cat([lap_a, torch.stack(rot_a)]))


def logsumdet_jet(t: Jet) -> Jet:
    """Jet of ``log sum_d det(Phi_d)`` from the jet of the orbital matrices.

    ``t.x``: ``[*B, ndet, n, n]`` complex.  Every derivative channel is solved
    against one LU factorisation per (walker, determinant): the channels'
    columns form one multi-RHS ``lu_solve``.
    """
    phi = t.x
    n = phi.shape[-1]
    e = t.extras
    ke = t.j.shape[0]  # K + E
    lead = phi.shape[:-1]

    j_cols = torch.movedim(t.j, 0, -2).reshape(*lead, ke * n)
    d_cols = torch.movedim(t.d, 0, -2).reshape(*lead, e * n)
    rhs = torch.cat([j_cols, t.l, d_cols], dim=-1)  # [*B, ndet, n, (ke+1+e)n]
    sign, logabs, m = slogdet_solve(phi, rhs)

    mj = torch.movedim(m[..., : ke * n].reshape(*lead, ke, n), -2, 0)
    ml = m[..., ke * n : (ke + 1) * n]
    md = torch.movedim(m[..., (ke + 1) * n :].reshape(*lead, e, n), -2, 0)

    jz = torch.diagonal(mj, dim1=-2, dim2=-1).sum(-1)  # [ke, *B, ndet]
    # tr((A^-1 dA)^2): summed over the Laplacian directions for l, per
    # direction for the extras.
    sq = torch.einsum("k...ij,k...ji->k...", mj, mj)
    lz = torch.diagonal(ml, dim1=-2, dim2=-1).sum(-1) - torch.sum(sq[: ke - e], dim=0)
    dz = torch.diagonal(md, dim1=-2, dim2=-1).sum(-1) - sq[ke - e :]

    z = Jet(logabs + torch.log(sign), jz, lz, dz)
    # log-sum-exp over determinants; the shift is a constant and cancels exactly.
    c = torch.amax(z.x.real, dim=-1, keepdim=True)
    ex = elementwise(exp, shift(z, -c))
    s = linear(lambda v: torch.sum(v, dim=-1), ex)
    out = elementwise(log, s)
    return shift(out, c[..., 0])
