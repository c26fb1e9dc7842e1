"""Exact-diagonalization eigenstates as first-quantized wavefunctions
(port of ``deephall_tpu/networks/edstate.py``).

An ``EDResult`` eigenvector of :mod:`deephall_tpu_torch.observables.ed`
becomes a ``data [..., nelec, 2] -> complex log psi`` callable.  The ED basis
states are Slater determinants of the LLL monopole orbitals ``phi_b = C_b u^b
v^{2Q-b}`` (``b = Q + m``, ``C_b^2 = (2Q+1) binom(2Q, b) / 4pi``, ascending
``b`` in each basis tuple) with real amplitudes, so

    psi_ED(x) = sum_k c_k det[ phi_{b_kj}(x_i) ] ,

a log-sum-exp over per-determinant ``slogdet`` values, which the full-Hessian
local energy (``hamiltonian.local_energy``) differentiates twice.

Being exact, the state gives the strongest oracles of the repo: at every
walker the kinetic local value is ``N/2`` and the ``L^2`` local value the
multiplet's eigenvalue; the mean local energy over ``|psi_ED|^2`` is the ED
eigenvalue ``N/2 + E_k``.
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.special import gammaln

from deephall_tpu_torch.config import System
from deephall_tpu_torch.geometry import spinors
from deephall_tpu_torch.observables import ed
from deephall_tpu_torch.ops.slogdet import slogdet


def make_ed_logpsi(result: ed.EDResult, two_q: int, state: int = 0):
    """First-quantized ``data [..., nelec, 2] -> complex log psi`` evaluator.

    Args:
        result: ED output whose eigenvector(s) to evaluate.  ``state > 0``
            needs ``result.states`` (the dense ``ed_block`` keeps the lowest
            ``num_states`` vectors; the native Lanczos path the ground state
            only).
        two_q: Monopole flux ``2Q`` of the block.
        state: Which eigenstate (0 = ground).

    Returns:
        A function of the electron configuration with arbitrary batch axes;
        its constants are placed on the caller's device in the caller's dtype.
    """
    if state == 0:
        amplitudes = result.ground_state
    else:
        if result.states is None:
            raise ValueError("EDResult carries no excited eigenvectors")
        amplitudes = result.states[:, state]
    n_orb = two_q + 1
    basis = np.array(result.basis)  # [dim, nelec], ascending rows
    bs = np.arange(n_orb)
    # C_b^2 = (2Q+1) binom(2Q, b) / (4 pi), in log space (2Q up to ~30 here).
    log_c = 0.5 * (
        np.log(n_orb)
        + gammaln(two_q + 1)
        - gammaln(bs + 1.0)
        - gammaln(two_q - bs + 1.0)
        - np.log(4.0 * np.pi)
    )
    constants: dict = {}

    def to_device(array: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
        # From pinned memory without blocking: a copy from pageable memory
        # would make the host wait for the card's queue.
        host = torch.as_tensor(np.asarray(array), dtype=dtype)
        if like.device.type == "cuda":
            host = host.pin_memory()
        return host.to(like.device, non_blocking=True)

    def on(like: torch.Tensor):
        key = (like.dtype, like.device)
        if key not in constants:
            # Made outside any torch.func transform, as utils.constant does.
            with torch._C._DisableFuncTorch():
                constants[key] = (
                    to_device(basis, like),
                    to_device(amplitudes, like, like.dtype),
                    to_device(np.exp(log_c), like, like.dtype),
                )
        return constants[key]

    def logpsi(data: torch.Tensor) -> torch.Tensor:
        basis_t, amps, c = on(data)
        u, v = spinors(data[..., 0], data[..., 1])  # [..., nelec]
        # Integer powers u^0..u^2Q by cumprod: no log(0) at the poles.
        ones = torch.ones_like(u[..., None])

        def powers(z):
            return torch.cumprod(torch.cat([ones, z[..., None].expand(*z.shape, two_q)], -1), -1)

        orbitals = c * powers(u) * powers(v).flip(-1)  # [..., nelec, n_orb]
        # Slater matrices of every basis state: [..., dim, nelec, nelec].
        mats = torch.movedim(orbitals[..., :, basis_t], -3, -2)
        sign, logabs = slogdet(mats)  # [..., dim]
        # Log-sum-exp shift: gradients flow through the terms, not the peak.
        peak = torch.amax(logabs, dim=-1).detach()
        terms = amps * sign * torch.exp(logabs - peak[..., None])
        return peak + torch.log(torch.sum(terms, dim=-1))

    return logpsi


def make_ed_network(system: System, state: int = 0, two_lz: int = 0, max_dim: int = 2000):
    """Run ED for ``system`` and wrap the eigenstate as a network.

    Returns ``(network, result)``: ``network(data) -> log psi`` has no
    parameters and drops into ``hamiltonian.local_energy`` and the fixed-state
    hooks of the loss.

    Raises:
        ValueError: If the Lz block exceeds ``max_dim``.  Each forward pass
            materialises a ``[batch, dim, nelec, nelec]`` complex Slater
            tensor (at batch 3360 about 1 GB per 1000 basis states for N=6),
            and the dense ``ed_block`` a ``dim^2`` Hamiltonian.
    """
    nelec = sum(system.nspins)
    dim = ed.lz_block_dim(abs(system.flux) + 1, nelec, two_lz)
    if dim > max_dim:
        raise ValueError(
            f"ED block N={nelec}, 2Q={abs(system.flux)}, 2Lz={two_lz} has "
            f"{dim} states (> max_dim={max_dim}): too large to use as a "
            "first-quantized wavefunction — the evaluator sums one determinant "
            "per basis state, materializing a [batch, dim, nelec, nelec] "
            f"complex tensor (~{3360 * dim * nelec * nelec * 8 / 1e9:.1f} GB "
            "at batch 3360). Use the Laughlin/CF overlap estimator or the "
            "native Lanczos backend for energies instead, or pass a larger "
            "max_dim explicitly with a reduced batch."
        )
    result = ed.ed_block(
        nelec,
        abs(system.flux),
        interaction=str(system.interaction_type),
        two_lz=two_lz,
        radius=system.radius,
        num_states=max(6, state + 1),
    )
    return make_ed_logpsi(result, abs(system.flux), state=state), result
