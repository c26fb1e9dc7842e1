"""Monopole spherical harmonics Y_{q,l,m} via Wigner rotation matrices
(port of ``deephall_tpu/observables/harmonics.py``).

Basis functions of the one-body reduced density matrix estimator.  In the
Wu-Yang gauge a monopole harmonic is a Wigner small-d matrix element dressed
with the azimuthal phase:

    Y_{q,l,m}(theta, phi) = sqrt((2l+1) / (4 pi)) * d^l_{q,m}(theta) * e^{i m phi},

with d^l_{q,m}(theta) = <l q| exp(-i theta J_y) |l m>, evaluated through its
Jacobi-polynomial representation: with

    k = min(l+m, l-m, l+q, l-q)        (branch choice)
    a = |m - q|,  b = 2l - 2k - a      (non-negative integers)
    xi = (-1)^a on the k = l+m and k = l-q branches, +1 otherwise

it is

    d^l_{q,m} = xi * sqrt( C(2l-k, k+a) / C(k+b, b) )
                * sin^a(theta/2) * cos^b(theta/2) * P_k^{(a,b)}(cos theta).

The Jacobi coefficients are made once on the host by the three-term
recurrence (small exact integers in float64); the evaluation is a float32
Horner polynomial in cos(theta) times half-angle monomials, exact at the poles
with no clipping.  The branch signs and the phase convention are those of the
JAX package, which pins them against exp(-i theta J_y) and scipy
(``tests/test_harmonics.py``, ``tests/test_torch_harmonics.py``).
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _jacobi_coefficients(k: int, a: int, b: int) -> np.ndarray:
    """Coefficients of P_k^{(a,b)} in ascending powers of x (three-term recurrence)."""
    if k == 0:
        return np.array([1.0])
    p_prev = np.array([1.0])
    p_cur = np.array([(a - b) / 2.0, (a + b) / 2.0 + 1.0])
    for n in range(2, k + 1):
        c = 2 * n + a + b
        denom = 2.0 * n * (n + a + b) * (c - 2)
        p_new = np.zeros(n + 1)
        p_new[:n] += ((c - 1) * (a * a - b * b) / denom) * p_cur
        p_new[1:] += ((c - 1) * c * (c - 2) / denom) * p_cur  # x * P_{n-1} term
        p_new[: n - 1] -= (2 * (n + a - 1) * (n + b - 1) * c / denom) * p_prev
        p_prev, p_cur = p_cur, p_new
    return p_cur


def make_monopole_harm(q: float, l: float, m: float):  # noqa: E741 - physics name
    """Build ``Y_qlm(electrons)`` evaluating one monopole harmonic.

    Args:
        q: Monopole strength (flux / 2); integer or half-integer.
        l: Angular momentum, ``l >= |q|`` with ``l - |q|`` integer.
        m: Azimuthal quantum number, ``-l <= m <= l``.

    Returns:
        Function mapping ``[..., 2]`` (theta, phi) float32 tensors to complex64
        values on their device.

    Raises:
        ValueError: if ``l < |q|`` or ``l < |m|``.
    """
    if not (l >= abs(q) and l >= abs(m)):
        raise ValueError(f"require l >= |q|, |m|; got q={q}, l={l}, m={m}")

    k = int(round(min(l + m, l - m, l + q, l - q)))
    a = int(round(abs(m - q)))
    b = int(round(2 * l - 2 * k)) - a
    negate = (k == round(l + m) or k == round(l - q)) and a % 2 == 1

    norm = math.sqrt(
        (2 * l + 1)
        / (4 * math.pi)
        * math.comb(int(round(2 * l)) - k, k + a)
        / math.comb(k + b, b)
    )
    if negate:
        norm = -norm
    # Descending float32 coefficients for Horner's rule, as ``jnp.polyval`` takes them.
    poly = [float(c) for c in _jacobi_coefficients(k, a, b)[::-1].astype(np.float32)]
    phase = 1j * float(m)

    def y_qlm(electrons: torch.Tensor) -> torch.Tensor:
        theta, phi = electrons[..., 0], electrons[..., 1]
        half = theta / 2
        x = torch.cos(theta)
        horner = torch.zeros_like(x)
        for c in poly:
            horner = horner * x + c
        d_elem = norm * torch.sin(half) ** a * torch.cos(half) ** b * horner
        return d_elem * torch.exp(phase * phi)

    return y_qlm
