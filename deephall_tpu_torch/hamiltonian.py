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
from deephall_tpu_torch.ops.fwdlap import hemisphere
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

    The jet (:func:`psiformer_logpsi_jet`) is of ``log psi' = log psi -
    i Q sum_i s_i phi_i``, each electron in the gauge regular at its nearer
    pole (``s_i = fwdlap.hemisphere(theta_i)``), along unit geodesics for the
    Laplacian and rotation flows for the angular momenta, so that no term
    larger than O(Q^2) is formed and then cancelled (near a pole the
    symmetric gauge's ``(Q / tan theta)^2`` terms cancel in float32).  In that
    gauge the vector potential along ``e_phi`` is
    ``A_i = -Q s_i sin theta_i / (1 + s_i cos theta_i)``, and

        KE  = -1/(2 r^2) sum_i [ Lap_i log psi' + g_theta_i^2 + (g_phi_i - i A_i)^2 ]
        L_a = sum_i (-i D_a + M_a(X_i)),   M_x = Q x / (1 + s z),
              M_y = Q y / (1 + s z),       M_z = Q s

    with ``g`` the derivatives along ``e_theta``, ``e_phi`` and ``D_a`` the
    rotation about axis ``a``.  So ``Lz = Im G_z + M_z`` and, the imaginary
    ``-i D_a M_a`` dropped with the real part,
    ``L^2 = sum_a Re[-D_a^2 - G_a^2 - 2i M_a G_a + M_a^2]`` (``G_a``,
    ``D_a^2`` the first and second derivatives of ``log psi'`` along the
    rotation).  Without ``compute_l2`` (or an ``l2_penalty``) ``L_square`` is
    NaN.

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
        sin_t, cos_t = torch.sin(theta), torch.cos(theta)
        s = hemisphere(theta)
        n = data.shape[-2]

        # Seed order (fwdlap.electron_seeds): row 2i is e_theta_i, row 2i+1 is
        # e_phi_i; the extra rows follow.
        jc = out.j_lap.reshape(n, 2, *out.x.shape)
        g_theta = torch.movedim(jc[:, 0], 0, -1)  # [*B, N]
        g_phi = torch.movedim(jc[:, 1], 0, -1)
        a_phi = -Q * s * sin_t / (1 + s * cos_t)
        kinetic = -(out.l + torch.sum(g_theta**2 + (g_phi - 1j * a_phi) ** 2, dim=-1)) / (
            2 * radius**2)

        def angular_square(g, d2, m):  # Re[-D^2 - G^2 - 2i M G + M^2] of one axis
            return (-d2 - g * g).real + 2 * m * g.imag + m * m

        g_z = out.j_extra[0]
        m_z = Q * torch.sum(s, dim=-1)
        if compute_l2:
            m_xy = Q * torch.sum(sin_t / (1 + s * cos_t) * torch.stack(
                [torch.cos(phi), torch.sin(phi)]), dim=-1)
            l_square = angular_square(g_z, out.d[0], m_z) + sum(
                angular_square(out.j_extra[a], out.d[a], m_xy[a - 1]) for a in (1, 2))
        else:
            l_square = torch.full(out.x.shape, math.nan, dtype=data.dtype, device=data.device)
        potential = pe(data) * system.interaction_strength
        observables = OtherObservables(
            angular_momentum_z=g_z.imag + m_z,
            angular_momentum_z_square=angular_square(g_z, out.d[0], m_z),
            angular_momentum_square=l_square,
            potential=potential,
            kinetic=kinetic,
        )
        return kinetic + potential, observables

    return e_l
