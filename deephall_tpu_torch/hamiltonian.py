"""Local energy of electrons on the monopole sphere (port of ``deephall_tpu/hamiltonian.py``).

Kinetic energy with the monopole terms, Coulomb or "harmonic" interaction, and
the Lz / Lz^2 / L^2 observables, by two routes:

* :func:`forward_laplacian_local_energy`, the Psiformer's: one forward-Laplacian
  jet of ``log psi`` through the hand-written kernels
  (:mod:`deephall_tpu_torch.networks.fwdlap`);
* :func:`local_energy`, every other network's (the analytic Laughlin / CF and
  ED states): the complex gradient and the full Hessian of a per-walker
  ``log psi`` from one ``torch.func.jacrev`` of ``[Re, Im]`` under one
  ``torch.func.jacfwd``, batched by ``torch.func.vmap``.  It shares none of
  the jet's rules, which makes it the jet's cross-check.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from functools import partial

import torch

from deephall_tpu_torch.config import InteractionType, System
from deephall_tpu_torch.geometry import pairwise_cos
from deephall_tpu_torch.types import AngularMomenta, OtherObservables


def _upper_mask(nelec: int, like: torch.Tensor) -> torch.Tensor:
    return torch.triu(torch.ones((nelec, nelec), dtype=like.dtype, device=like.device), 1)


def coulomb_potential(cos12: torch.Tensor, Q: float, r: float) -> torch.Tensor:
    """Coulomb energy summed over distinct pairs, from the pairwise cosines."""
    del Q
    nelec = cos12.shape[-1]
    eye = torch.eye(nelec, dtype=cos12.dtype, device=cos12.device)
    # The identity keeps the masked-out diagonal finite (no 0 * inf).
    r_ee = torch.sqrt(torch.clamp(2 - 2 * cos12, min=0)) + eye
    return torch.sum(_upper_mask(nelec, cos12) / r_ee, dim=(-2, -1)) / r


def harmonic_potential(cos12: torch.Tensor, Q: float) -> torch.Tensor:
    """Haldane-pseudopotential interaction ``1 + (Q+1)/Q cos(theta_12)`` over pairs."""
    nelec = cos12.shape[-1]
    return torch.sum(_upper_mask(nelec, cos12) * (1 + (Q + 1) / Q * cos12), dim=(-2, -1))


def make_potential(
    interaction_type: InteractionType, Q: float, r: float
) -> Callable[[torch.Tensor], torch.Tensor]:
    """The potential-energy function of configurations ``[..., N, 2]``."""
    if interaction_type == InteractionType.coulomb:
        pair_fn = partial(coulomb_potential, Q=Q, r=r)
    elif interaction_type == InteractionType.harmonic:
        pair_fn = partial(harmonic_potential, Q=Q)
    else:  # pragma: no cover - config enum is closed
        raise ValueError(f"Unknown interaction type {interaction_type}")

    def potential(data: torch.Tensor) -> torch.Tensor:
        return pair_fn(pairwise_cos(data))

    return potential


def _assemble_observables(
    theta: torch.Tensor,
    phi: torch.Tensor,
    grad: torch.Tensor,
    hess: torch.Tensor,
    Q: float,
    r: float,
) -> tuple[torch.Tensor, AngularMomenta]:
    """Kinetic energy and angular momenta of one walker from the complex
    gradient ``[N, 2]`` and Hessian ``[N, 2, N, 2]`` of ``log psi`` (the JAX
    package's operator algebra, ``deephall_tpu/hamiltonian.py:_assemble_observables``).

    Each electron's terms in 1/sin^2(theta) are gathered before they are
    rounded, as ``-(h_pp + (g_phi - iQ cos theta)^2) / sin^2 theta`` in both the
    kinetic energy and L^2: at an electron at eps from a pole each of them is of
    order Q^2 / eps^2 while their sum stays finite, so summed one by one they
    would lose digits as 1/eps^2.
    """
    g_theta, g_phi = grad[..., 0], grad[..., 1]
    sin_t, cos_t, tan_t = torch.sin(theta), torch.cos(theta), torch.tan(theta)
    h_tt = hess[:, 0, :, 0]
    h_tp = hess[:, 0, :, 1]
    h_pp = hess[:, 1, :, 1]
    polar = (torch.diagonal(h_pp) + (g_phi - 1j * Q * cos_t) ** 2) / sin_t**2

    kinetic_energy = -torch.sum(
        g_theta / tan_t + torch.diagonal(h_tt) + g_theta**2 + polar) / 2 / r**2

    # L^2 = sum over pairs of the angular-momentum operators' products; [3, N]
    # Cartesian components, ``col`` / ``row`` the two electron axes.  A pair's
    # terms are summed over the components; each electron's own pair is
    # -psi_tt + Q^2 - polar.
    r_hat = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t])
    phi_hat = torch.stack([-torch.sin(phi), torch.cos(phi), torch.zeros_like(phi)])
    theta_hat_prime = torch.stack(
        [torch.cos(phi) / tan_t, torch.sin(phi) / tan_t, -torch.ones_like(theta)]
    )

    def col(x):
        return x[..., :, None]

    def row(x):
        return x[..., None, :]

    psi_tt = h_tt + col(g_theta) * row(g_theta)
    psi_tp = h_tp + col(g_theta) * row(g_phi)
    psi_pp = h_pp + col(g_phi) * row(g_phi)
    magnetic_term = Q * (theta_hat_prime * cos_t + r_hat)
    pairs = torch.sum(
        2 * col(phi_hat) * row(theta_hat_prime) * psi_tp
        - col(phi_hat) * row(phi_hat) * psi_tt
        - col(theta_hat_prime) * row(theta_hat_prime) * psi_pp
        - (2j * row(magnetic_term))
        * (col(phi_hat) * col(g_theta) - col(theta_hat_prime) * col(g_phi))
        + col(magnetic_term) * row(magnetic_term),
        dim=0,
    )
    own = torch.eye(theta.shape[-1], dtype=torch.bool, device=theta.device)
    angular_momentum_square = (
        torch.sum(torch.where(own, torch.zeros_like(pairs), pairs))
        + torch.sum(Q**2 - torch.diagonal(psi_tt) - polar)
        - torch.sum(g_theta / tan_t)  # diagonal correction for non-commuting terms
    )

    return kinetic_energy, AngularMomenta(
        angular_momentum_z=torch.sum(g_phi).imag,
        angular_momentum_z_square=-torch.sum(psi_pp).real,
        angular_momentum_square=angular_momentum_square.real,
    )


def make_local_kinetic_energy(f, Q: float, r: float):
    """The per-walker local kinetic energy of ``f``.

    Args:
        f: complex ``log psi`` of one configuration, ``data [N, 2] -> []``.
        Q: monopole strength (flux / 2).
        r: sphere radius.

    Returns:
        ``ke(data [N, 2]) -> (kinetic_energy, AngularMomenta)``; batch it with
        ``torch.func.vmap``.
    """

    def stacked_grad(x):
        def re_im(y):
            out = f(y)
            return torch.stack([out.real, out.imag])

        g = torch.func.jacrev(re_im)(x)
        return g, g

    def ke(data: torch.Tensor) -> tuple[torch.Tensor, AngularMomenta]:
        hess_ri, grad_ri = torch.func.jacfwd(stacked_grad, has_aux=True)(data)
        grad = torch.complex(grad_ri[0], grad_ri[1])  # [N, 2]
        hess = torch.complex(hess_ri[0], hess_ri[1])  # [N, 2, N, 2]
        return _assemble_observables(data[..., 0], data[..., 1], grad, hess, Q, r)

    return ke


def local_energy(f, system: System):
    """The per-walker local energy of ``f`` by the full Hessian (JAX
    ``hamiltonian.local_energy``).

    Args:
        f: complex ``log psi`` of one configuration, ``data [N, 2] -> []``.
        system: system configuration (flux, radius, interaction).

    Returns:
        ``e_l(data [N, 2]) -> (E_L, OtherObservables)``; batch it with
        ``torch.func.vmap``.
    """
    Q = system.flux / 2
    radius = system.radius if system.radius is not None else math.sqrt(Q)
    ke = make_local_kinetic_energy(f, Q, radius)
    pe = make_potential(system.interaction_type, Q, radius)

    def e_l(data: torch.Tensor) -> tuple[torch.Tensor, OtherObservables]:
        potential = pe(data) * system.interaction_strength
        kinetic, angular_momenta = ke(data)
        return kinetic + potential, OtherObservables(
            **angular_momenta, potential=potential, kinetic=kinetic)

    return e_l


def forward_laplacian_local_energy(model, system: System, kernels: bool = True):
    """Batched local energy from one forward-Laplacian pass.

    With ``compute_l2`` (or an ``l2_penalty``) two more jet directions are carried
    and

        L^2 = sum_a [ -u_a^T H u_a - G_a^2 - 2i Mbar_a G_a + Mbar_a^2 ]
              - sum_i g_theta_i / tan theta_i

    with ``G_a`` and ``u_a^T H u_a`` read from the jet and
    ``Mbar_a = sum_i Q (thetahat'_a cos theta + rhat_a)_i`` analytic.  Otherwise
    ``L_square`` is NaN.

    Args:
        model: the Psiformer.
        system: system configuration.
        kernels: passed to :func:`psiformer_logpsi_jet`.

    Returns:
        ``e_l(data[B, N, 2]) -> (E_L [B] complex, OtherObservables)``.
    """
    from deephall_tpu_torch.networks.fwdlap import psiformer_logpsi_jet

    Q = system.flux / 2
    radius = system.radius if system.radius is not None else math.sqrt(Q)
    pe = make_potential(system.interaction_type, Q, radius)
    compute_l2 = bool(system.compute_l2 or system.l2_penalty)

    def e_l(data: torch.Tensor) -> tuple[torch.Tensor, OtherObservables]:
        out = psiformer_logpsi_jet(model, data, compute_l2=compute_l2, kernels=kernels)
        theta, phi = data[..., 0], data[..., 1]
        sin_t, cos_t, tan_t = torch.sin(theta), torch.cos(theta), torch.tan(theta)
        n = data.shape[-2]

        # Seed order (fwdlap.electron_seeds): row 2i is e_theta_i, row 2i+1 is
        # e_phi_i / sin(theta_i); the extra rows follow.
        jc = out.j_lap.reshape(n, 2, *out.x.shape)
        g_theta = torch.movedim(jc[:, 0], 0, -1)  # [*B, N]
        g_phi = torch.movedim(jc[:, 1], 0, -1) * sin_t

        square_grad_logpsi = torch.sum(out.j_lap**2, dim=0)
        grad_grad_logpsi = torch.sum(g_theta / tan_t, dim=-1) + out.l
        magnetic_contribution = torch.sum(
            (Q / tan_t) ** 2 + 2j * Q * cos_t / sin_t**2 * g_phi, dim=-1
        )
        kinetic = (
            -grad_grad_logpsi - square_grad_logpsi + magnetic_contribution
        ) / 2 / radius**2

        g_phi_sum = out.j_extra[0]
        if compute_l2:
            r_hat = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t])
            theta_hat_prime = torch.stack(
                [torch.cos(phi) / tan_t, torch.sin(phi) / tan_t, -torch.ones_like(theta)]
            )
            mbar = torch.sum(Q * (theta_hat_prime * cos_t + r_hat), dim=-1)
            # u_z is the Lz direction (extra row 0); order (x, y, z) as mbar's.
            g_a = torch.stack([out.j_extra[1], out.j_extra[2], out.j_extra[0]])
            d2_a = torch.stack([out.d[1], out.d[2], out.d[0]])
            l_square = (
                torch.sum(-d2_a - g_a**2 - 2j * mbar * g_a + mbar**2, dim=0)
                - torch.sum(g_theta / tan_t, dim=-1)
            ).real
        else:
            l_square = torch.full(out.x.shape, math.nan, dtype=data.dtype, device=data.device)
        potential = pe(data) * system.interaction_strength
        observables = OtherObservables(
            angular_momentum_z=g_phi_sum.imag,
            angular_momentum_z_square=-(out.d[0] + g_phi_sum**2).real,
            angular_momentum_square=l_square,
            potential=potential,
            kinetic=kinetic,
        )
        return kinetic + potential, observables

    return e_l
