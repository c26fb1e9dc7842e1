"""The port's monopole harmonics against the JAX package and independent oracles.

``make_monopole_harm`` agrees with JAX's over integer and half-integer
``(q, l, m)``, both poles included, within 1e-5 of the largest ``|Y|`` (float32
Horner polynomials, the same coefficients); and it meets the oracles of
``tests/test_harmonics.py``: the ``exp(-i theta J_y)`` matrix, q = 0 against
scipy, orthonormality on an exact quadrature, the LLL envelope and the
``ValueError``.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu.observables.harmonics import make_monopole_harm as jax_make_monopole_harm
from deephall_tpu_torch.geometry import spinors
from deephall_tpu_torch.observables.harmonics import make_monopole_harm

torch.set_num_threads(2)


def points(seed: int, n: int) -> np.ndarray:
    """``[n + 2, 2]`` float32 points: the two poles, then uniform ones."""
    rng = np.random.default_rng(seed)
    theta = np.concatenate([[0.0, np.float32(np.pi)], np.arccos(rng.uniform(-1, 1, n))])
    phi = rng.uniform(-np.pi, np.pi, n + 2)
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def harm(q, l, m, pts: np.ndarray) -> np.ndarray:  # noqa: E741
    return make_monopole_harm(q, l, m)(torch.from_numpy(pts)).numpy()


@pytest.mark.parametrize("two_q", [0, 1, 3, 6, 15])
def test_matches_jax(two_q):
    q = two_q / 2
    pts = points(two_q, 40)
    for l in np.arange(q, q + 3):  # noqa: E741
        for m in np.arange(-l, l + 1):
            got = harm(q, l, m, pts)
            want = np.asarray(jax_make_monopole_harm(q, l, m)(jnp.asarray(pts)))
            assert got.dtype == np.complex64
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), (q, l, m)


def _wigner_d_expm(l, theta):  # noqa: E741
    """d^l(theta) = exp(-i theta J_y) by eigendecomposition; basis m = -l..l."""
    dim = int(round(2 * l)) + 1
    ms = np.array([-l + i for i in range(dim)])
    j_plus = np.zeros((dim, dim))
    for i in range(dim - 1):
        j_plus[i + 1, i] = np.sqrt(l * (l + 1) - ms[i] * (ms[i] + 1))
    j_y = (j_plus - j_plus.T) / 2j
    w, v = np.linalg.eigh(j_y)
    return (v @ np.diag(np.exp(-1j * theta * w)) @ v.conj().T).real, ms


@pytest.mark.parametrize("twol", [1, 2, 3, 5, 8])
def test_matches_jy_exponential(twol):
    l = twol / 2  # noqa: E741
    thetas = np.array([0.0, 0.4, 1.3, 2.6, np.pi], dtype=np.float32)
    pts = np.stack([thetas, np.zeros_like(thetas)], axis=-1)
    for k, theta in enumerate(thetas):
        d_mat, ms = _wigner_d_expm(l, float(theta))
        for i, q in enumerate(ms):
            for j, m in enumerate(ms):
                got = complex(harm(q, l, m, pts)[k])
                want = math.sqrt((2 * l + 1) / (4 * math.pi)) * d_mat[i, j]
                assert got.imag == pytest.approx(0.0, abs=1e-5)
                assert got.real == pytest.approx(want, abs=2e-5)


def test_q0_reduces_to_spherical_harmonics():
    """At q=0: scipy's Y_l^m without the Condon-Shortley phase (the Wu-Yang gauge)."""
    sph_harm = pytest.importorskip("scipy.special").sph_harm_y
    rng = np.random.default_rng(3)
    theta = rng.uniform(0.05, np.pi - 0.05, 7)
    phi = rng.uniform(-np.pi, np.pi, 7)
    pts = np.stack([theta, phi], axis=-1).astype(np.float32)
    for l in range(5):  # noqa: E741
        for m in range(-l, l + 1):
            want = (-1.0) ** m * sph_harm(l, m, theta, phi)
            np.testing.assert_allclose(harm(0.0, float(l), float(m), pts), want, atol=1e-5)


@pytest.mark.parametrize("q", [0.0, 0.5, 1.0, 2.5])
def test_orthonormal_on_exact_quadrature(q):
    """<Y_{q,l,m} | Y_{q,l',m'}> = delta by Gauss-Legendre x uniform-phi quadrature."""
    l_max = q + 2
    basis = [(l, m) for l in np.arange(q, l_max + 1) for m in np.arange(-l, l + 1)]  # noqa: E741
    n_leg = int(2 * l_max) + 2
    x_nodes, x_weights = np.polynomial.legendre.leggauss(n_leg)
    n_phi = int(4 * l_max) + 3
    phi_nodes = 2 * np.pi * np.arange(n_phi) / n_phi
    theta_grid, phi_grid = np.meshgrid(np.arccos(x_nodes), phi_nodes, indexing="ij")
    pts = np.stack([theta_grid.ravel(), phi_grid.ravel()], axis=-1).astype(np.float32)
    weights = np.repeat(x_weights, n_phi) * (2 * np.pi / n_phi)
    ys = np.stack([harm(q, l, m, pts) for l, m in basis], axis=-1)  # noqa: E741
    gram = np.einsum("n,ni,nj->ij", weights, np.conj(ys), ys)
    np.testing.assert_allclose(gram, np.eye(len(basis)), atol=2e-4)


def test_lll_matches_network_envelope():
    """Y_{q,q,m} = (-1)^(q-m) sqrt((2q+1)/4pi * C(2q, q-m)) u^(q+m) v^(q-m)."""
    q = 1.5
    rng = np.random.default_rng(5)
    pts = np.stack([rng.uniform(0.1, np.pi - 0.1, 9), rng.uniform(-np.pi, np.pi, 9)],
                   axis=-1).astype(np.float32)
    u, v = spinors(torch.from_numpy(pts[:, 0]).double(), torch.from_numpy(pts[:, 1]).double())
    for m in np.arange(-q, q + 1):
        coeff = math.sqrt((2 * q + 1) / (4 * math.pi) * math.comb(int(2 * q), int(q - m)))
        want = (-1.0) ** int(q - m) * coeff * (u ** (q + m) * v ** (q - m)).numpy()
        np.testing.assert_allclose(harm(q, q, m, pts), want, atol=1e-5)


def test_rejects_invalid_quantum_numbers():
    with pytest.raises(ValueError):
        make_monopole_harm(2.0, 1.0, 0.0)
    with pytest.raises(ValueError):
        make_monopole_harm(0.0, 1.0, 2.0)
