"""Exact diagonalization of the lowest-Landau-level problem on the sphere.

A copy of ``deephall_tpu/observables/ed.py`` (NumPy and SciPy only), so that
the port needs no JAX; only the imports and the citations differ.

An independent, from-first-principles oracle for the variational results: the
many-body Hamiltonian restricted to the lowest Landau level (LLL) of the
Haldane sphere is a finite matrix, so small systems — including the production
N=6, 2Q=15 (nu=1/3) system, whose Lz=0 block has only a few hundred states —
can be solved *exactly* on the host CPU.  This converts BASELINE.md's
"VMC energy is consistent with the Laughlin anchor" statements into hard
comparisons against the true LLL ground state, and provides closed-form
oracles (hard-core Laughlin zero modes, the harmonic interaction's exact
``a + b L(L+1)`` spectrum) that pin the entire pipeline end to end.

Everything here is plain NumPy/SciPy float64 — ED is a host-side analysis
tool, not a TPU hot path.  Conventions follow the framework's Hamiltonian
exactly (``deephall_tpu_torch/hamiltonian.py``, mirroring the reference
DeepHall's ``hamiltonian.py:27-60``):

* Coulomb: ``V = sum_{i<j} 1 / (R * chord_ij)`` with ``R = sqrt(Q)`` unless
  overridden (``hamiltonian.py:236``).  On the unit sphere
  ``1/chord = sum_k P_k(cos gamma)`` (Legendre generating function at t=1),
  and the LLL projection truncates the sum exactly at ``k = 2Q``.
* Harmonic: ``V = sum_{i<j} [1 + (Q+1)/Q * cos gamma_ij]`` with no radius
  factor (``hamiltonian.py:61-76``).  Within the LLL this is exactly
  ``N(N-1)/2 + [L(L+1) - N Q(Q+1)] / (2Q(Q+1))`` — a pure function of the
  total angular momentum (the LLL projection of the position operator is
  proportional to the single-particle angular momentum), which
  ``tests/test_ed.py`` uses as a closed-form oracle.

Single-particle matrix elements of ``Y_kq`` between LLL monopole harmonics
(``u^{Q+m} v^{Q-m}`` up to normalization, ``deephall_tpu_torch/geometry.spinors``)
are computed by Gauss-Legendre quadrature of their explicit radial profiles —
exact for these band-limited integrands — rather than 3j-symbol tables, so
this module shares no code (and no potential common-mode bug) with the
Wigner-d machinery in ``observables/harmonics.py``.

Energies returned are the *interaction* part only.  For a total-energy
comparison with VMC add the frozen-LLL kinetic energy ``N/2``
(``total_energy`` helper); the neural wavefunction is not LLL-restricted, so
its variational total may dip slightly below ``N/2 + E0`` through
Landau-level mixing — by less than the cyclotron gap's suppression allows.
"""

from __future__ import annotations

from dataclasses import dataclass
from itertools import combinations

import numpy as np
from scipy.special import gammaln, lpmv


# --------------------------------------------------------------------------- #
# Single-particle LLL orbitals and Y_kq matrix elements
# --------------------------------------------------------------------------- #


def _radial_profiles(two_q: int, nodes: np.ndarray) -> np.ndarray:
    """Normalized LLL radial profiles ``f_m(x)`` on quadrature nodes.

    The LLL orbital with ``Lz = m`` is ``f_m(cos theta) e^{i m phi}`` with
    ``f_m = C (cos theta/2)^{Q+m} (sin theta/2)^{Q-m}`` — the
    ``u^{Q+m} v^{Q-m}`` monopole envelope of the networks.  Normalization is
    fixed on the grid itself (``2 pi * sum_i w_i f_m(x_i)^2 = 1``), which both
    avoids binomial overflow and validates the quadrature.

    Returns ``[n_orb, n_nodes]`` with orbitals ordered by ``m = -Q .. Q``.
    """
    cos_half = np.sqrt((1.0 + nodes) / 2.0)
    sin_half = np.sqrt((1.0 - nodes) / 2.0)
    two_ms = np.arange(-two_q, two_q + 1, 2)
    # log-space for stability at large 2Q
    log_c = np.log(np.maximum(cos_half, 1e-300))
    log_s = np.log(np.maximum(sin_half, 1e-300))
    logs = (
        ((two_q + two_ms) / 2.0)[:, None] * log_c[None, :]
        + ((two_q - two_ms) / 2.0)[:, None] * log_s[None, :]
    )
    f = np.exp(logs - logs.max(axis=1, keepdims=True))
    return f


def y_matrix_elements(two_q: int) -> dict[tuple[int, int], np.ndarray]:
    """``<m'| Y_kq |m>`` between LLL orbitals, for all ``k <= 2Q``.

    Returns a dict ``{(k, q): M}`` with ``M[i', i]`` the element between
    orbitals ``i -> i'`` (m-order ``-Q..Q``); only the single diagonal
    ``m' = m + q`` is nonzero, and all entries are real.
    """
    n_orb = two_q + 1
    n_nodes = 2 * two_q + 32
    nodes, weights = np.polynomial.legendre.leggauss(n_nodes)
    f = _radial_profiles(two_q, nodes)
    norm = np.sqrt(2.0 * np.pi * np.sum(weights * f**2, axis=1))
    f = f / norm[:, None]

    out: dict[tuple[int, int], np.ndarray] = {}
    for k in range(two_q + 1):
        for q in range(-k, k + 1):
            # Y_kq = N_kq P_k^|q| (x) e^{iq phi} with Condon-Shortley in lpmv;
            # negative q via Y_{k,-q} = (-1)^q conj(Y_kq).
            aq = abs(q)
            log_n = 0.5 * (
                np.log((2 * k + 1) / (4.0 * np.pi))
                + gammaln(k - aq + 1)
                - gammaln(k + aq + 1)
            )
            s = np.exp(log_n) * lpmv(aq, k, nodes)
            if q < 0:
                s = s * (-1.0) ** aq
            m = np.zeros((n_orb, n_orb))
            for i in range(n_orb):
                ip = i + q  # m' = m + q
                if 0 <= ip < n_orb:
                    # phi integral: (1/2pi) * 2pi = 1 with grid-normalized f
                    m[ip, i] = 2.0 * np.pi * np.sum(weights * f[ip] * s * f[i])
            if np.any(m != 0.0):
                out[(k, q)] = m
    return out


# --------------------------------------------------------------------------- #
# Two-body matrix elements in the product basis
# --------------------------------------------------------------------------- #


def pair_elements(
    two_q: int, interaction: str = "coulomb", radius: float | None = None
) -> np.ndarray:
    """Product-basis two-body elements ``V[a', b', a, b] = <a'b'|V(1,2)|ab>``.

    ``a/b`` index orbitals ``m = -Q..Q``; particle 1 scatters ``a -> a'`` and
    particle 2 ``b -> b'``.  Uses the addition theorem
    ``P_k(cos g12) = 4pi/(2k+1) sum_q Y_kq(1) Y_kq*(2)`` so each term factors
    into two single-particle integrals.

    Args:
        two_q: Monopole flux ``2Q`` (integer).
        interaction: ``"coulomb"`` (``sum_k P_k / R``) or ``"harmonic"``
            (``1 + (Q+1)/Q P_1``, no radius factor) — the same two
            interactions ``hamiltonian.make_potential`` offers.
        radius: Sphere radius for Coulomb; defaults to ``sqrt(Q)``.

    Returns:
        ``[n, n, n, n]`` real array, ``n = 2Q + 1``.
    """
    q_half = two_q / 2.0
    n = two_q + 1
    elems = y_matrix_elements(two_q)
    v4 = np.zeros((n, n, n, n))

    if interaction == "coulomb":
        k_list = range(two_q + 1)

        def coeff(k: int) -> float:
            return 4.0 * np.pi / (2 * k + 1) / (
                float(radius) if radius is not None else np.sqrt(q_half)
            )

    elif interaction == "harmonic":
        k_list = [1]

        def coeff(k: int) -> float:
            return (q_half + 1.0) / q_half * 4.0 * np.pi / 3.0

        idx = np.arange(n)
        v4[idx[:, None], idx[None, :], idx[:, None], idx[None, :]] += 1.0
    else:  # pragma: no cover - mirrors the closed config enum
        raise ValueError(f"Unknown interaction {interaction}")

    for k in k_list:
        for q in range(-k, k + 1):
            m1 = elems.get((k, q))
            if m1 is None:
                continue
            # <a'|Y_kq|a> <b'|Y_kq*|b> = M[a',a] * M[b,b']  (real M)
            v4 += coeff(k) * np.einsum("ca,db->cdab", m1, m1.T)
    return v4


def pseudopotentials(two_q: int, interaction: str = "coulomb") -> np.ndarray:
    """Fermionic Haldane pseudopotentials ``V_J`` for pair angular momentum J.

    Diagonalizes the two-particle interaction in the antisymmetric space;
    allowed ``J = 2Q-1, 2Q-3, ...`` (odd relative angular momentum).  Returns
    the ``V_J`` ordered by decreasing ``J`` (increasing pair separation is
    increasing relative m = 2Q - J).
    """
    v4 = pair_elements(two_q, interaction)
    energies, _, l_values = _two_body_spectrum(two_q, v4)
    js = sorted(set(l_values), reverse=True)
    out = []
    for j in js:
        vals = energies[np.isclose(l_values, j)]
        assert np.ptp(vals) < 1e-9, (j, vals)
        out.append(vals.mean())
    return np.asarray(out)


def _two_body_spectrum(two_q: int, v4: np.ndarray):
    """Eigen-decomposition of the antisymmetrized two-body interaction."""
    n = two_q + 1
    pairs = list(combinations(range(n), 2))
    h = np.zeros((len(pairs), len(pairs)))
    for r, (k, l) in enumerate(pairs):
        for c, (i, j) in enumerate(pairs):
            h[r, c] = v4[k, l, i, j] - v4[l, k, i, j]
    energies, vecs = np.linalg.eigh(h)
    # identify each eigenstate's pair angular momentum via L^2
    l_values = np.array(
        [
            _l_from_l2(float(v @ _apply_total_l2(two_q, pairs, v)))
            for v in vecs.T
        ],
        dtype=float,
    )
    return energies, vecs, l_values


def _l_from_l2(l2_value: float) -> float:
    return round(0.5 * (-1.0 + np.sqrt(1.0 + 4.0 * max(l2_value, 0.0))), 6)


# --------------------------------------------------------------------------- #
# Many-body basis and Hamiltonian
# --------------------------------------------------------------------------- #


@dataclass
class EDResult:
    """Exact-diagonalization output for one (N, 2Q, Lz) block."""

    energies: np.ndarray  # lowest eigenvalues of the interaction, ascending
    ground_l2: float  # <L^2> of the ground state
    dim: int  # dimension of the Lz block
    ground_state: np.ndarray  # amplitudes in the occupation basis
    basis: list[tuple[int, ...]]  # occupied-orbital tuples (m-order -Q..Q)
    states: np.ndarray | None = None  # [dim, num_states] eigenvectors (dense path)

    def total_energy(self, nelec: int, interaction_strength: float = 1.0) -> float:
        """Frozen-LLL total energy: kinetic ``N/2`` plus the interaction part.

        Matches the training Hamiltonian's convention (KE of any LLL state is
        ``N/2``, pinned by ``tests/test_hamiltonian.py``; the interaction is
        scaled by ``system.interaction_strength``).
        """
        return nelec / 2.0 + interaction_strength * float(self.energies[0])


def pair_correlation_curve(
    result: EDResult, two_q: int, bins: int = 200
) -> np.ndarray:
    """Exact pair-correlation histogram of an ``L = 0`` eigenstate.

    Returns the *expected value* of ``observables.estimators.pair_histogram``'s
    bins for walkers drawn from ``|psi_ED|^2`` — directly overlayable on the
    measured VMC artifacts (``runs/*_pair_corr.npz``).  Rotational invariance
    pins one electron at the pole, where only the ``m = Q`` orbital is
    nonzero, so the whole 2-RDM collapses to the pair occupations
    ``<n_Q n_b>`` and the curve is

        E[bin(theta)] = 4 pi (2Q+1) / N^2 * sum_b f_b(cos theta)^2 <n_Q n_b>

    (the estimator's bins estimate ``16 pi^2 G(theta) / N^2`` for the
    pair-density kernel ``G``; a uniform uncorrelated gas gives the finite-size
    plateau ``(N-1)/N``).  ``f_b`` are the normalized LLL radial profiles.
    Verified analytically at nu = 1, where ``<n_Q n_b> = 1`` and completeness
    reduces this to the filled-LLL kernel form ``1 - cos^{4Q}(theta/2)``
    (``tests/test_ed.py``).

    Args:
        result: An :class:`EDResult` whose ground state has ``L^2 ~= 0``
            (the formula assumes rotational invariance of ``|psi|^2``).
        two_q: Monopole flux ``2Q`` of the block.
        bins: Histogram resolution (the estimator default is 200).
    """
    if abs(result.ground_l2) > 1e-3:
        raise ValueError(
            f"pair_correlation_curve needs an L=0 state, got L^2={result.ground_l2}"
        )
    n_orb = two_q + 1
    nelec = len(result.basis[0])
    occ_pairs = _pole_pair_occupations(result, n_orb)
    centers = (np.arange(bins) + 0.5) * np.pi / bins
    x = np.cos(centers)
    # grid-free normalization: 2 pi int f_m^2 dx = 1 analytically via the
    # beta function -> C_m^2 = (2Q+1) binom(2Q, Q+m) / (4 pi); in log space.
    two_ms = np.arange(-two_q, two_q + 1, 2)
    log_c2 = (
        np.log(two_q + 1.0)
        + gammaln(two_q + 1)
        - gammaln((two_q + two_ms) / 2.0 + 1)
        - gammaln((two_q - two_ms) / 2.0 + 1)
        - np.log(4.0 * np.pi)
    )
    cos_half2 = (1.0 + x) / 2.0
    sin_half2 = (1.0 - x) / 2.0
    logs = (
        ((two_q + two_ms) / 2.0)[:, None] * np.log(np.maximum(cos_half2, 1e-300))
        + ((two_q - two_ms) / 2.0)[:, None] * np.log(np.maximum(sin_half2, 1e-300))
    )
    f2 = np.exp(log_c2[:, None] + logs)  # f_b(x)^2, normalized
    return 4.0 * np.pi * (two_q + 1) / nelec**2 * (occ_pairs @ f2)


def _pole_pair_occupations(result: EDResult, n_orb: int) -> np.ndarray:
    """Ground-state pair occupations ``<n_Q n_b>`` against the pole orbital.

    Rotational invariance collapses the 2-RDM of an ``L = 0`` state onto these
    (shared by :func:`pair_correlation_curve` and :func:`structure_factor`).
    """
    pole = n_orb - 1  # the m = +Q orbital
    occ_pairs = np.zeros(n_orb)
    for amp, occ in zip(result.ground_state, result.basis):
        if pole in occ:
            w = amp * amp
            for b in occ:
                if b != pole:
                    occ_pairs[b] += w
    return occ_pairs


def state_l2(result: EDResult, two_q: int, state: int = 0) -> float:
    """``<L^2>`` of eigenstate ``state`` (dense path keeps the vectors)."""
    if state == 0:
        vec = result.ground_state
    else:
        if result.states is None:
            raise ValueError("EDResult carries no excited eigenvectors")
        vec = result.states[:, state]
    return float(vec @ _apply_total_l2(two_q, result.basis, vec))


def structure_factor(result: EDResult, two_q: int, lmax: int = 8) -> np.ndarray:
    """Exact static structure factor multipoles of an ``L = 0`` eigenstate.

    ``S_L = 1 + (N-1) E_pair[P_L(cos theta_12)]`` — the sphere analogue of
    ``S(q) = 1 + rho Int (g-1)`` via the addition theorem for the density
    multipoles ``rho_LM = sum_i Y_LM(Omega_i)``.  Rotational invariance
    collapses the pair density to the pole-pair occupations exactly as in
    :func:`pair_correlation_curve`; the ``E_pair[P_L]`` integrals are done by
    Gauss-Legendre quadrature, exact for these band-limited integrands.

    Oracle (pinned in ``tests/test_ed.py``): within the LLL the projected
    position operator is ``L_i/(Q+1)`` whose square is ``Q/(Q+1)`` (not 1 —
    the projection eats the diagonal), so every LLL eigenstate obeys exactly

        S_1 = 1/(Q+1) + L(L+1) / (N (Q+1)^2) ,

    i.e. ``1/(Q+1)`` for every rotation-invariant ground state — the sphere
    version of the ``q^2/2`` incompressibility bound on S(q -> 0).

    Returns:
        ``[lmax + 1]`` array, ``S_0 = N`` trivially.
    """
    if abs(result.ground_l2) > 1e-3:
        raise ValueError(
            f"structure_factor needs an L=0 state, got L^2={result.ground_l2}"
        )
    n_orb = two_q + 1
    nelec = len(result.basis[0])
    occ_pairs = _pole_pair_occupations(result, n_orb)
    nodes, weights = np.polynomial.legendre.leggauss(2 * two_q + lmax + 16)
    f2 = _radial_profiles(two_q, nodes) ** 2  # unnormalized; constants cancel
    norm = np.sum(weights * f2, axis=1)
    density = occ_pairs @ (f2 / norm[:, None])  # pair pdf on the nodes (up to const)
    z = np.sum(weights * density)
    out = np.empty(lmax + 1)
    for lval in range(lmax + 1):
        p_l = np.polynomial.legendre.Legendre.basis(lval)(nodes)
        out[lval] = 1.0 + (nelec - 1) * np.sum(weights * density * p_l) / z
    return out


def _apply_one_body(
    mat: np.ndarray,
    shift: int,
    src_basis: list[tuple[int, ...]],
    dst_index: dict[tuple[int, ...], int],
    vec: np.ndarray,
) -> np.ndarray:
    """Apply ``O = sum_m mat[m+shift, m] c+_{m+shift} c_m`` to ``vec``.

    ``mat`` is a single-``q`` matrix from :func:`y_matrix_elements` (only the
    ``m' = m + shift`` diagonal is nonzero); the result lives in the
    ``Lz + shift`` block indexed by ``dst_index``.  Fermion signs follow the
    same convention as ``_apply_total_l2``'s ladder helper: basis tuples are
    ascending, annihilation at position ``pos`` contributes ``(-1)^pos`` and
    re-insertion ``(-1)^{new position}``.
    """
    n = mat.shape[0]
    out = np.zeros(len(dst_index))
    for row, occ in enumerate(src_basis):
        amp = vec[row]
        if amp == 0.0:
            continue
        occ_set = set(occ)
        for pos, orb in enumerate(occ):
            t = orb + shift
            if t < 0 or t >= n:
                continue
            el = mat[t, orb]
            if el == 0.0:
                continue
            if t != orb and t in occ_set:
                continue  # Pauli blocked
            new_occ = tuple(sorted(occ_set - {orb} | {t}))
            col = dst_index.get(new_occ)
            if col is None:
                continue
            sign = (-1.0) ** (pos + new_occ.index(t))
            out[col] += sign * el * amp
    return out


def sma_spectrum(
    nelec: int,
    two_q: int,
    lmax: int = 6,
    interaction: str = "coulomb",
    radius: float | None = None,
    mval: int | None = None,
) -> list[dict]:
    """Exact single-mode-approximation (GMP) magnetoroton bounds per ``L``.

    Girvin-MacDonald-Platzman's magnetoroton ansatz (PRB 33, 2481 (1986)) on
    the Haldane sphere: the trial excitation in the ``L`` multiplet is the
    LLL-projected density multipole acting on the exact ground state,

        |L, M> = rho_LM |0>,    rho_LM = sum_m <m+M| Y_LM |m> c+_{m+M} c_m ,

    (the LLL projection is built in — the matrix elements are taken between
    LLL orbitals only).  Because ``rho_LM`` is a rank-``L`` tensor operator
    and ``|0>`` is a scalar, ``|L, M>`` is a *pure* ``L`` multiplet member, so

        Delta_SMA(L) = <L|H|L>/<L|L> - E0  >=  Delta_exact(L)

    is a variational upper bound on the magnetoroton branch sector by sector —
    the classic analysis the VMC dispersion (``scripts/magnetoroton.py``) is
    compared against.  The projected structure factor
    ``sbar(L) = <0|rho_LM^+ rho_LM|0> / N`` (``M``-independent by rotational
    invariance) comes out for free; the ``L = 1`` multipole is exactly
    ``sqrt(3/4pi) L_tot / (Q+1)`` within the LLL, which annihilates any
    ``L = 0`` ground state — ``sbar(1) = 0`` is the sphere statement of the
    ``q -> 0`` incompressibility that kills the SMA state at smallest ``k``
    (both identities pinned in ``tests/test_sma.py``).

    This is an analysis capability beyond the reference's surface (its loss
    stops at ground-state penalties, DeepHall's ``loss.py:76-88``
    — it ships no ED, no SMA, no dispersion tooling).

    Args:
        nelec: Electron count (spin-polarized).
        two_q: Monopole flux ``2Q``.
        lmax: Largest multipole; must stay ``<= 2Q`` (beyond that the LLL
            matrix elements vanish identically).
        interaction: ``"coulomb"`` or ``"harmonic"`` (see :func:`pair_elements`).
        radius: Coulomb sphere-radius override (default ``sqrt(Q)``).
        mval: ``M`` of the multipole (default ``L``, landing the state in the
            ``Lz = L`` block — the same block the VMC sector runs target).
            Any ``|M| <= L`` gives identical ``sbar``/gaps (tested).

    Returns:
        One dict per ``L = 1..lmax``: ``{"l", "sbar", "sma_gap",
        "sma_energy"}`` — interaction-only energies; ``sma_gap``/``sma_energy``
        are ``None`` where ``sbar`` is numerically zero (no SMA state).
    """
    n_orb = two_q + 1
    v4 = pair_elements(two_q, interaction, radius)
    ground = ed_block(
        nelec, two_q, interaction, two_lz=0, radius=radius, num_states=1, v4=v4
    )
    e0 = float(ground.energies[0])
    elems = y_matrix_elements(two_q)
    out: list[dict] = []
    for lval in range(1, lmax + 1):
        m_use = lval if mval is None else mval
        mat = elems.get((lval, m_use))
        if mat is None:
            raise ValueError(f"no Y_{lval}{m_use} elements at 2Q={two_q}")
        dst_basis = lz_basis(n_orb, nelec, 2 * m_use)
        dst_index = {occ: r for r, occ in enumerate(dst_basis)}
        v = _apply_one_body(mat, m_use, ground.basis, dst_index, ground.ground_state)
        norm2 = float(v @ v)
        row = {"l": lval, "sbar": norm2 / nelec, "sma_gap": None, "sma_energy": None}
        if norm2 > 1e-12:
            hv = _apply_interaction(v4, dst_basis, dst_index, v)
            e_sma = float(v @ hv) / norm2
            row["sma_energy"] = e_sma
            row["sma_gap"] = e_sma - e0
        out.append(row)
    return out


def lz_basis(n_orb: int, nelec: int, two_lz: int) -> list[tuple[int, ...]]:
    """Occupation basis (tuples of orbital indices) with ``sum 2m = two_lz``."""
    two_q = n_orb - 1
    out = []
    for occ in combinations(range(n_orb), nelec):
        if sum(2 * i - two_q for i in occ) == two_lz:
            out.append(occ)
    return out


def lz_block_dim(n_orb: int, nelec: int, two_lz: int) -> int:
    """Dimension of the ``Lz`` block, without enumerating it.

    Counting DP over orbitals (subset-sum occupation count), O(n_orb^2 nelec)
    — feasibility guards must not pay the full ``lz_basis`` walk (13M
    combinations at N=10, 2Q=27) just to learn a block is too big.
    Pinned against ``len(lz_basis(...))`` in ``tests/test_ed.py``.
    """
    # counts[k][s] = #subsets of the first o orbitals with k electrons and
    # index sum s; sum 2m = two_lz <=> index sum = (two_lz + nelec*(n_orb-1))/2.
    target2 = two_lz + nelec * (n_orb - 1)
    if target2 % 2 or target2 < 0:
        return 0
    target = target2 // 2
    max_sum = min(target, nelec * (n_orb - 1))
    counts = np.zeros((nelec + 1, max_sum + 1), dtype=np.int64)
    counts[0, 0] = 1
    for orb in range(n_orb):
        for k in range(min(nelec, orb + 1), 0, -1):
            hi = max_sum - orb
            if hi >= 0:
                counts[k, orb:] += counts[k - 1, : hi + 1]
    return int(counts[nelec, target]) if target <= max_sum else 0


def _apply_interaction(
    v4: np.ndarray, basis: list[tuple[int, ...]], index: dict, vec: np.ndarray
) -> np.ndarray:
    """Apply ``sum_{i<j,k<l} <kl|V|ij>_A c+_k c+_l c_j c_i`` to ``vec``."""
    n = v4.shape[0]
    out = np.zeros_like(vec)
    for row, occ in enumerate(basis):
        amp = vec[row]
        if amp == 0.0:
            continue
        occ_set = set(occ)
        occ_list = list(occ)
        for ai in range(len(occ_list)):
            for bi in range(ai + 1, len(occ_list)):
                i, j = occ_list[ai], occ_list[bi]  # i < j annihilated
                # fermion sign for c_j c_i on |occ> (i<j, both present)
                sign0 = (-1.0) ** (occ_list.index(i) + occ_list.index(j) + 1)
                rest = occ_set - {i, j}
                mi_mj = (i + j)
                for k in range(n):
                    l_orb = mi_mj - k  # Lz conservation: m_k + m_l = m_i + m_j
                    if l_orb <= k or l_orb >= n:
                        continue
                    if k in rest or l_orb in rest:
                        continue
                    # antisymmetrized element <k l|V|i j>_A
                    el = v4[k, l_orb, i, j] - v4[l_orb, k, i, j]
                    if el == 0.0:
                        continue
                    new_occ = tuple(sorted(rest | {k, l_orb}))
                    col = index.get(new_occ)
                    if col is None:
                        continue
                    new_list = list(new_occ)
                    sign1 = (-1.0) ** (new_list.index(k) + new_list.index(l_orb) + 1)
                    out[col] += sign0 * sign1 * el * amp
    return out


def _build_hamiltonian(v4: np.ndarray, basis: list[tuple[int, ...]]) -> np.ndarray:
    index = {occ: r for r, occ in enumerate(basis)}
    dim = len(basis)
    h = np.zeros((dim, dim))
    for c in range(dim):
        e = np.zeros(dim)
        e[c] = 1.0
        h[:, c] = _apply_interaction(v4, basis, index, e)
    return h


def _apply_total_l2(
    two_q: int, basis: list[tuple[int, ...]], vec: np.ndarray
) -> np.ndarray:
    """Apply the total ``L^2 = L- L+ + Lz(Lz + 1)`` (routes through Lz+1)."""
    n = two_q + 1
    q_half = two_q / 2.0
    ms = np.arange(n) - q_half

    def lp_amp(m: float) -> float:
        return np.sqrt(max(q_half * (q_half + 1) - m * (m + 1), 0.0))

    def apply_ladder(src_basis, src_vec, shift, amp_fn):
        dest: dict[tuple[int, ...], float] = {}
        for row, occ in enumerate(src_basis):
            amp = src_vec[row]
            if amp == 0.0:
                continue
            occ_set = set(occ)
            for pos, orb in enumerate(occ):
                t = orb + shift
                if t < 0 or t >= n or t in occ_set:
                    continue
                new_occ = tuple(sorted(occ_set - {orb} | {t}))
                sign = (-1.0) ** (pos + new_occ.index(t))
                dest[new_occ] = dest.get(new_occ, 0.0) + sign * amp_fn(ms[orb]) * amp
        return dest

    # L+ into the Lz+1 sector (dict keyed by occupation), then L- back.
    up = apply_ladder(basis, vec, +1, lp_amp)
    up_basis = list(up)
    up_vec = np.array([up[occ] for occ in up_basis])
    down = apply_ladder(up_basis, up_vec, -1, lambda m: lp_amp(m - 1))

    index = {occ: r for r, occ in enumerate(basis)}
    out = np.zeros_like(vec)
    for occ, a in down.items():
        r = index.get(occ)
        if r is not None:
            out[r] += a
    # Diagonal Lz(Lz + 1), computed per basis state so mixed-Lz bases (the
    # two-body spectrum helper) work too; fixed-Lz blocks are a special case.
    lz_diag = np.array(
        [sum(2 * i - two_q for i in occ) / 2.0 for occ in basis]
    )
    return out + lz_diag * (lz_diag + 1.0) * vec


def ed_block(
    nelec: int,
    two_q: int,
    interaction: str = "coulomb",
    two_lz: int = 0,
    radius: float | None = None,
    num_states: int = 6,
    v4: np.ndarray | None = None,
) -> EDResult:
    """Exactly diagonalize one ``(N, 2Q, Lz)`` block of the LLL Hamiltonian.

    Args:
        nelec: Electron count (spin-polarized, as the production systems).
        two_q: Monopole flux ``2Q``.
        interaction: ``"coulomb"`` or ``"harmonic"`` (see :func:`pair_elements`).
        two_lz: Twice the total ``Lz`` of the block (0 contains every ``L``
            multiplet, including any ``L = 0`` incompressible ground state).
        radius: Coulomb sphere radius override (default ``sqrt(Q)``).
        num_states: How many lowest eigenvalues to return.
        v4: Optional precomputed/modified product-basis elements — the
            hard-core (``V_1``-only) oracle passes a projected table here.

    Returns:
        :class:`EDResult` with interaction-only energies (ascending).
    """
    n_orb = two_q + 1
    if v4 is None:
        v4 = pair_elements(two_q, interaction, radius)
    basis = lz_basis(n_orb, nelec, two_lz)
    if not basis:
        raise ValueError(f"empty Lz block: N={nelec}, 2Q={two_q}, 2Lz={two_lz}")
    h = _build_hamiltonian(v4, basis)
    energies, vecs = np.linalg.eigh(h)
    ground = vecs[:, 0]
    l2 = float(ground @ _apply_total_l2(two_q, basis, ground))
    return EDResult(
        energies=energies[:num_states],
        ground_l2=l2,
        dim=len(basis),
        ground_state=ground,
        basis=basis,
        states=vecs[:, :num_states],
    )


def hardcore_v1_elements(two_q: int) -> np.ndarray:
    """Product-basis elements of the ``V_1``-only hard-core interaction.

    Projects the pair space onto the ``J = 2Q - 1`` multiplet (relative
    angular momentum 1) with unit pseudopotential.  The Laughlin ``m = 3``
    state at ``2Q = 3(N-1)`` is this interaction's *exact*, unique, zero-energy
    ground state in the ``Lz = 0`` sector — the strongest available oracle for
    the many-body machinery (arXiv:2412.14795's model-interaction anchor).
    """
    n = two_q + 1
    # Construct the pair states |J=2Q-1, M> directly from Clebsch-Gordan-free
    # ladder operations and project onto the multiplet.
    q_half = two_q / 2.0
    ms = np.arange(n) - q_half

    def lp_amp(m: float) -> float:
        return np.sqrt(max(q_half * (q_half + 1) - m * (m + 1), 0.0))

    # Highest-weight pair state with J = 2Q - 1, M = 2Q - 1:
    # the unique antisymmetric combination of {|Q, Q-1>, |Q-1, Q>}:
    # (|Q>|Q-1> - |Q-1>|Q>)/sqrt(2).  Lower with J- = L-(1) + L-(2).
    states = []  # list of [n, n] antisymmetric amplitude matrices A[a, b]
    a0 = np.zeros((n, n))
    a0[n - 1, n - 2] = 1.0 / np.sqrt(2.0)
    a0[n - 2, n - 1] = -1.0 / np.sqrt(2.0)
    states.append(a0)
    cur = a0
    j = two_q - 1
    for m_idx in range(2 * j):
        nxt = np.zeros((n, n))
        for a in range(n):
            for b in range(n):
                if cur[a, b] == 0.0:
                    continue
                if a - 1 >= 0:
                    nxt[a - 1, b] += lp_amp(ms[a] - 1) * cur[a, b]
                if b - 1 >= 0:
                    nxt[a, b - 1] += lp_amp(ms[b] - 1) * cur[a, b]
        nxt /= np.linalg.norm(nxt)
        states.append(nxt)
        cur = nxt
    v4 = np.zeros((n, n, n, n))
    for a in states:
        # projector in the *product* basis; <kl|P|ij> = A[k,l] A*[i,j]
        v4 += np.einsum("kl,ij->klij", a, a)
    return v4


def main() -> None:  # pragma: no cover - thin CLI
    import argparse

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--nelec", type=int, required=True)
    parser.add_argument("--flux", type=int, required=True, help="2Q")
    parser.add_argument("--interaction", default="coulomb")
    parser.add_argument("--two-lz", type=int, default=0)
    parser.add_argument("--states", type=int, default=6)
    parser.add_argument(
        "--backend",
        choices=["dense", "native"],
        default="dense",
        help="native = C++ matvec + Lanczos (ed_native.py), for large blocks",
    )
    args = parser.parse_args()
    if args.backend == "native":
        from deephall_tpu_torch.observables.ed_native import ed_ground_lanczos

        res = ed_ground_lanczos(
            args.nelec,
            args.flux,
            interaction=args.interaction,
            two_lz=args.two_lz,
            num_states=args.states,
            tol=1e-10,
        )
    else:
        res = ed_block(
            args.nelec,
            args.flux,
            interaction=args.interaction,
            two_lz=args.two_lz,
            num_states=args.states,
        )
    total = res.total_energy(args.nelec)
    print(f"block dim {res.dim}")
    print("interaction energies:", " ".join(f"{e:.6f}" for e in res.energies))
    print(f"ground <L^2> = {res.ground_l2:.6f}")
    print(
        f"ground interaction = {res.energies[0]:.6f}, "
        f"frozen-LLL total = {total:.6f} (KE = N/2)"
    )


if __name__ == "__main__":
    main()
