"""The necessary work of the local energy's orbital jet, from the configuration's sizes.

The span ``orbitals`` of the port covers the orbital head's projection of the
tower's output jet, the contraction of its features with each electron's
monopole-harmonic envelope, and the determinants' LU factorisations and
solves.  Their work is counted here from the sizes alone, whatever computes
them, and frozen, so that a change to the program cannot change the
yardstick.  The least time is the larger of the operations at three TF32
products' rate (as :func:`benchmark.work.kernels.attention_least` bounds the
attention's GEMMs) and the bytes at the HBM's rate.
"""

from __future__ import annotations

from benchmark.work.kernels import MEMORY_RATE, TF32X3_RATE, Least

COMPLEX_MAC = 8  # real operations of one complex multiply-add


def orbital_jet_work(batch: int, nelec: int, flux: int, features: int, ndet: int,
                     c: int, e: int) -> tuple[int, int]:
    """``(bytes, operations)`` of the orbital jet of ``batch`` walkers.

    The jet has ``P = c + e + 2`` planes: the primal, ``c`` tangents (the
    ``c - e`` Laplacian ones, then ``e`` extra rotations), the Laplacian and
    ``e`` second derivatives.

    * Projection: each plane of the tower's ``[B, N, D]`` output jet by the
      head's real and imaginary kernels, ``F = (2Q + 1) N K`` features an
      electron: two real products a plane, ``4 P B N D F``.
    * Envelope contraction over the ``2Q + 1`` harmonics, one complex
      multiply-add each, for every (walker, electron, orbital, determinant):
      the primal; every tangent of the features against the envelope's
      primal, and the features' primal against the envelope's own two
      tangents and the extras (an electron's envelope moves with it alone);
      the Laplacian's two products and its cross terms over the electron's
      two tangents; two products and a cross term an extra.
    * Determinants: for each (walker, determinant) one complex LU of ``N x N``
      (``8 N^3 / 3``) and forward and back solves of the ``(c + 1 + e) N``
      derivative columns (``8 N^2`` each).

    Bytes: the tower's jet read once (float32) and the orbital matrices' jet
    written once (complex64).
    """
    planes = c + e + 2
    head = 4 * planes * batch * nelec * features * ndet * (flux + 1) * nelec
    contractions = 1 + c + (2 + e) + 4 + 3 * e
    envelope = COMPLEX_MAC * batch * nelec * nelec * ndet * (flux + 1) * contractions
    columns = (c + 1 + e) * nelec
    determinants = batch * ndet * (COMPLEX_MAC * nelec**3 // 3 + COMPLEX_MAC * nelec**2 * columns)
    nbytes = planes * batch * nelec * features * 4 + planes * batch * ndet * nelec * nelec * 8
    return nbytes, head + envelope + determinants


def orbital_jet_least(batch, nelec, flux, features, ndet, c, e) -> Least:
    """The least time of one local energy's orbital jet."""
    nbytes, operations = orbital_jet_work(batch, nelec, flux, features, ndet, c, e)
    ops, by_bytes = operations / TF32X3_RATE, nbytes / MEMORY_RATE
    return Least(ops, "operations") if ops >= by_bytes else Least(by_bytes, "bytes")
