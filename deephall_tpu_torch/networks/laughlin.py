"""Analytic Laughlin / composite-fermion wavefunctions (port of ``deephall_tpu/networks/laughlin.py``).

Composite-fermion states at effective flux ``Q1 = Q - p (N - 1)`` with ``p =
cf_flux``: the ground state (N = 2 Q1 + 1), one quasihole (N = 2 Q1), one
quasiparticle (N = 2 Q1 + 2, projected into the lowest Landau level by
``u* -> d/du``, ``v* -> d/dv``), the Jain nu = 2/5 state with the hand-derived
two-level projection (N = 4 Q1 + 4) and the general n-level construction from
the monomial expansion of each Lambda level (nu = 3/7, N = 6 Q1 + 9).

The module has no parameters.  Powers of the spinors take float exponents, as
the JAX package's do, so that both agree to rounding; the exponents, and the
general construction's term tables, are constants built in ``__init__`` and
placed on the caller's device in the caller's dtype.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from deephall_tpu_torch.geometry import spinors
from deephall_tpu_torch.ops.slogdet import signed_logsumdet
from deephall_tpu_torch.utils import constant


def lambda_level_terms(two_q1: int, level: int) -> list[list[tuple[float, int, int, int, int]]]:
    """Monomial expansion of one composite-fermion Lambda level's orbitals.

    At monopole charge ``Q1 = two_q1 / 2`` the ``level``-th Lambda level carries
    angular momentum ``l = Q1 + level``. Its top state ``u^(2Q1+level) (v*)^level``
    is annihilated by ``L+ = u d/dv - v* d/du*``; repeatedly applying
    ``L- = v d/du - u* d/dv*`` sweeps out the full multiplet with exact integer
    coefficients (no closed-form monopole-harmonic coefficient tables needed).

    Returns one term list per orbital (m = l down to -l), each term
    ``(coef, a, b, c, d)`` meaning ``coef * u^a v^b (u*)^c (v*)^d``, with the
    coefficients of each orbital rescaled to max |coef| = 1 (a per-determinant-
    column constant, physically irrelevant) so factorial growth never reaches
    the f32 evaluation.
    """
    state: dict[tuple[int, int, int, int], int] = {(two_q1 + level, 0, 0, level): 1}
    orbitals = []
    for _ in range(two_q1 + 2 * level + 1):  # 2l + 1 members
        scale = max(abs(c) for c in state.values())
        orbitals.append([(c / scale, *k) for k, c in sorted(state.items())])
        lowered: dict[tuple[int, int, int, int], int] = {}
        for (a, b, c, d), coef in state.items():
            if a > 0:
                key = (a - 1, b + 1, c, d)
                lowered[key] = lowered.get(key, 0) + coef * a
            if d > 0:
                key = (a, b, c + 1, d - 1)
                lowered[key] = lowered.get(key, 0) - coef * d
        state = {k: c for k, c in lowered.items() if c != 0}
    assert not state, "lowering past m = -l must annihilate the state"
    return orbitals


# The Jain-Kamilla derivatives ``d^c/du^c d^d/dv^d`` of the Jastrow, in the
# order of ``Laughlin._jastrow_derivatives``'s stack.
_DERIVATIVES = ((0, 0), (1, 0), (0, 1), (2, 0), (0, 2), (1, 1))


def _as_tuples(arrays: dict) -> dict:
    return {k: tuple(float(x) for x in np.atleast_1d(v)) for k, v in arrays.items()}


class Laughlin(nn.Module):
    """Laughlin/CF wavefunction for ground or quasiparticle/quasihole states.

    ``forward(electrons[..., N, 2], dtype=None) -> log psi [...]`` (complex);
    ``dtype`` is ignored (the reduced-precision sweep concerns the Psiformer's
    feature tower only).
    """

    def __init__(self, nspins: tuple[int, int], flux: float, cf_flux: int = 1,
                 excitation_lz: float = 0):
        super().__init__()
        self.nspins = tuple(nspins)
        self.flux = flux
        self.cf_flux = cf_flux
        self.excitation_lz = excitation_lz
        nelec = sum(self.nspins)
        self.Q1 = Q = flux / 2 - cf_flux * (nelec - 1)
        if nelec == 2 * Q + 1:  # Ground state
            m = np.arange(-Q, Q + 1)
            self._exponents = {"u": Q + m, "v": Q - m}
            self.cf_orbitals = self.full_orbitals
        elif nelec == 2 * Q:  # Quasihole
            self._check_lz(abs(Q))
            # Remove the m = -excitation_lz LLL orbital: enumerate from both ends.
            m = np.concatenate([np.arange(-Q, -excitation_lz), np.arange(Q, -excitation_lz, -1)])
            self._exponents = {"u": Q + m, "v": Q - m}
            self.cf_orbitals = self.full_orbitals
        elif nelec == 2 * Q + 2:  # Quasiparticle
            self._check_lz(abs(Q) + 1)
            m = np.arange(-Q, Q + 1)
            m1 = excitation_lz
            self._exponents = {"u": Q + m, "v": Q - m, "u1": [Q + m1], "v1": [Q - m1]}
            self.cf_orbitals = self.quasiparticle_orbitals
        elif nelec == 4 * Q + 4:  # Jain nu=2/5: two filled Lambda levels
            m0 = np.arange(-Q, Q + 1)
            m1 = np.arange(-(Q + 1), Q + 2)
            coef_v = Q + 1 + m1  # multiplies the v * d/dv term
            coef_u = Q + 1 - m1  # multiplies the u * d/du term
            self._exponents = {
                "u": Q + m0, "v": Q - m0, "coef_v": coef_v, "coef_u": coef_u,
                # At the shell edges m1 = +-(Q1 + 1) one of the two projected
                # terms has coefficient zero beside a negative exponent; the
                # exponent is clamped (the term vanishes either way) so that
                # theta = 0 / pi stays finite.
                "u_dv": np.where(coef_v > 0, Q + m1, 0), "v_dv": Q + 1 - m1,
                "u_du": Q + m1 + 1, "v_du": np.where(coef_u > 0, Q - m1, 0),
            }
            self.cf_orbitals = self.jain_two_level_orbitals
        elif nelec == 6 * Q + 9:  # Jain nu=3/7: three filled Lambda levels
            self.use_general_jain(3)
        else:
            raise ValueError("Filling not supported")
        self._exponents = _as_tuples(self._exponents)

    def _check_lz(self, bound: float) -> None:
        """The requested Lz must be attainable for the excitation."""
        diff = self.excitation_lz - self.Q1
        if int(diff) != diff or not -bound <= self.excitation_lz <= bound:
            raise ValueError(f"Impossible Lz={self.excitation_lz} for excitation")

    def use_general_jain(self, n_levels: int) -> None:
        """Evaluate ``n_levels`` filled Lambda levels by the general construction
        (:meth:`jain_orbitals`), whose term tables are built here."""
        two_q1 = int(round(2 * self.Q1))
        if two_q1 != 2 * self.Q1:
            raise ValueError("2*Q1 must be integral")
        terms = [(col, *term)
                 for col, orbital in enumerate(
                     o for level in range(n_levels) for o in lambda_level_terms(two_q1, level))
                 for term in orbital]
        column, coef, a, b, c, d = (np.array(v) for v in zip(*terms))
        self.n_columns = int(column[-1]) + 1
        self._exponents = _as_tuples({"coef": coef, "a": a, "b": b})
        self._term_index = {
            "derivative": [_DERIVATIVES.index((ci, di)) for ci, di in zip(c, d)],
            "column": column.tolist(),
        }
        self.cf_orbitals = self.jain_orbitals

    def _const(self, name: str, like: torch.Tensor) -> torch.Tensor:
        """The constant ``name`` on ``like``'s device, in its real dtype."""
        return constant(self._exponents[name], like.real.dtype, like.device)

    def forward(self, electrons: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        del dtype
        if self.cf_orbitals == self.full_orbitals:
            # det[Y_im J_i] = det(Y) prod_i J_i: the Jastrow's factors leave the
            # determinant as a sum of logs.  The value is the same; its second
            # derivative in phi at an electron near a pole, which the local
            # energy divides by sin^2(theta), keeps ten times more digits.
            u, v = spinors(electrons[..., 0], electrons[..., 1])
            u, v = u[..., None], v[..., None]
            element, _ = self._pair_jastrow(u, v)
            lll = self._lll(u, v, "u", "v")[..., None, :, :]
            return signed_logsumdet(lll) + torch.log(element).sum(dim=(-2, -1))
        # Add the determinant-expansion axis expected by signed_logsumdet.
        return signed_logsumdet(self.orbitals(electrons)[..., None, :, :])

    def orbitals(self, electrons: torch.Tensor) -> torch.Tensor:
        u, v = spinors(electrons[..., 0], electrons[..., 1])
        return self.cf_orbitals(u[..., None], v[..., None])

    @staticmethod
    def _pair_jastrow(u: torch.Tensor, v: torch.Tensor):
        """prod_j (u_i v_j - u_j v_i) with the diagonal masked to 1."""
        u_row, v_row = u.mT, v.mT  # [..., 1, N]
        eye = torch.eye(u.shape[-2], dtype=u.real.dtype, device=u.device)
        element = u * v_row - u_row * v + eye
        return element, torch.prod(element, dim=-1, keepdim=True)

    def _lll(self, u, v, a: str, b: str) -> torch.Tensor:
        """``u^a v^b`` with the exponents ``a``, ``b`` from ``_exponents``."""
        a, b = self._const(a, u), self._const(b, u)
        # Polar form, |u|^a |v|^b e^{i (a arg u + b arg v)}: the same float
        # exponents as the JAX package's complex power, and 0^0 = 1.
        return torch.polar(u.abs() ** a * v.abs() ** b, a * u.angle() + b * v.angle())

    def full_orbitals(self, u, v):
        """The ground state, or the quasihole with one orbital left out."""
        _, jastrow = self._pair_jastrow(u, v)
        return self._lll(u, v, "u", "v") * jastrow

    def _jastrow_first_derivatives(self, u, v):
        """``(J, dJ/dv, dJ/du)``, projected as in the JAX package."""
        element, jastrow = self._pair_jastrow(u, v)
        jastrow_dv = jastrow * (torch.sum(-u.mT / element, dim=-1, keepdim=True) + u)
        jastrow_du = jastrow * (torch.sum(v.mT / element, dim=-1, keepdim=True) - v)
        return jastrow, jastrow_dv, jastrow_du

    def quasiparticle_orbitals(self, u, v):
        Q, m1 = self.Q1, self.excitation_lz
        jastrow, jastrow_dv, jastrow_du = self._jastrow_first_derivatives(u, v)
        # LLL projection: u* -> d/du, v* -> d/dv acting on the Jastrow product.
        excited = self._lll(u, v, "u1", "v1") * (
            (Q + 1 + m1) * v * jastrow_dv - (Q + 1 - m1) * u * jastrow_du
        )
        return torch.cat([self._lll(u, v, "u", "v") * jastrow, excited], dim=-1)

    def jain_two_level_orbitals(self, u, v):
        """Two filled composite-fermion Lambda levels: the Jain nu=2/5 state.

        The lowest level (l = Q1, 2 Q1 + 1 orbitals) is the ground-state
        construction; the second level (l = Q1 + 1, 2 Q1 + 3 orbitals) applies
        the quasiparticle projection to every member m1 of the shell, so
        N = 4 Q1 + 4 in total.
        """
        jastrow, jastrow_dv, jastrow_du = self._jastrow_first_derivatives(u, v)
        excited = (self._const("coef_v", u) * self._lll(u, v, "u_dv", "v_dv")) * jastrow_dv - (
            self._const("coef_u", u) * self._lll(u, v, "u_du", "v_du")
        ) * jastrow_du
        return torch.cat([self._lll(u, v, "u", "v") * jastrow, excited], dim=-1)

    def _jastrow_derivatives(self, u, v) -> torch.Tensor:
        """Jain-Kamilla derivative family of the attached-flux Jastrow.

        ``[..., N, 1, 6]``: ``d^c/du^c d^d/dv^d prod_j (u v_j - u_j v)`` per
        particle for ``(c, d)`` in ``_DERIVATIVES`` (total order up to 2). With
        ``e_ij = u_i v_j - u_j v_i`` the logarithmic derivatives are power
        sums, ``dJ/du = J sum_j v_j/e_ij`` and ``dJ/dv = -J sum_j u_j/e_ij``,
        and the second order follows by one more product rule.  The diagonal
        ``e_ii = 1`` entries of :meth:`_pair_jastrow` contribute exactly
        ``v_i``, ``u_i``, ``v_i^2`` ... to the raw sums and are subtracted.
        """
        element, jastrow = self._pair_jastrow(u, v)
        rv = v.mT / element
        ru = u.mT / element
        sv = torch.sum(rv, dim=-1, keepdim=True) - v
        su = torch.sum(ru, dim=-1, keepdim=True) - u
        sv2 = torch.sum(rv * rv, dim=-1, keepdim=True) - v * v
        su2 = torch.sum(ru * ru, dim=-1, keepdim=True) - u * u
        suv = torch.sum(ru * rv, dim=-1, keepdim=True) - u * v
        return torch.stack([
            jastrow, jastrow * sv, -jastrow * su,
            jastrow * (sv * sv - sv2), jastrow * (su * su - su2), jastrow * (suv - su * sv),
        ], dim=-1)

    def jain_orbitals(self, u, v):
        """``n_levels`` filled CF Lambda levels (Jain ``nu = n/(2n+1)``).

        Each Lambda-level orbital is a :func:`lambda_level_terms` monomial sum;
        the Jain-Kamilla projection replaces ``(u*)^c (v*)^d`` by
        ``d^c/du^c d^d/dv^d`` acting on the per-particle Jastrow only.  All
        terms are evaluated at once, ``[..., N, terms]``, and summed into their
        columns by a 0/1 matrix.
        """
        index = {k: constant(tuple(v), torch.long, u.device) for k, v in self._term_index.items()}
        jd = self._jastrow_derivatives(u, v)[..., 0, :]  # [..., N, 6]
        terms = self._const("coef", u) * self._lll(u, v, "a", "b") * jd[..., index["derivative"]]
        columns = torch.arange(self.n_columns, device=u.device)
        select = (index["column"][:, None] == columns).to(terms.dtype)
        return terms @ select
