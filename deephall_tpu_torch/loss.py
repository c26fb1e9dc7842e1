"""Clipped-energy statistics (port of ``deephall_tpu/loss.py``, ``ENERGY_DIFF`` mode).

IQR clipping of the local energy (real and imaginary parts separately, median
+- 100 IQR), the optional Lz / L^2 penalty terms folded into the per-walker
differences, and NaN-resistant means for the logged statistics.  The gradient
modes belong to the training slice.
"""

from __future__ import annotations

import enum

import torch

from deephall_tpu_torch.config import System
from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
from deephall_tpu_torch.types import LossStats


def nanmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the entries that are not NaN (either part, for complex input)."""
    if not x.is_complex():
        return torch.nanmean(x)
    valid = ~torch.isnan(x)
    return torch.where(valid, x, torch.zeros_like(x)).sum() / valid.sum()


def iqr_clip_real(x: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    q1 = torch.nanquantile(x, 0.25)
    q3 = torch.nanquantile(x, 0.75)
    iqr = q3 - q1
    return torch.clamp(x, q1 - scale * iqr, q3 + scale * iqr)


def iqr_clip(x: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    return torch.complex(iqr_clip_real(x.real, scale), iqr_clip_real(x.imag, scale))


class LossMode(enum.Enum):
    ENERGY_GRAD = enum.auto()
    ENERGY_DIFF = enum.auto()
    SR_F_VECTOR = enum.auto()


def stats_and_clipped_diff(
    system: System, el: torch.Tensor, other_observables: dict
) -> tuple[LossStats, torch.Tensor]:
    """Per-step statistics and the clipped per-walker energy differences.

    The Lz / L^2 penalty branches follow ``deephall_tpu/loss.py:
    stats_and_clipped_diff``, including ``l2_center`` and ``l2_adaptive``.
    With ``dynamic_penalties`` the JAX package assembles the penalty terms
    unconditionally (a zero strength multiplies them away); the same branch
    conditions are kept here, with the values read from the config.
    """
    mean_observables = {k: nanmean(v) for k, v in other_observables.items()}
    loss = nanmean(el)
    clipped_loss = nanmean(iqr_clip(el))
    diff_to_clip = el - clipped_loss
    dynamic = system.dynamic_penalties
    k_eff = None
    if (dynamic and system.compute_l2) or system.l2_penalty:
        l2 = other_observables["angular_momentum_square"]
        clipped_l2 = nanmean(iqr_clip_real(l2))
        if system.l2_adaptive:
            k_eff = system.l2_penalty * torch.clamp(clipped_l2 - system.l2_center, 0.0, 1.0)
        else:
            k_eff = system.l2_penalty * (clipped_l2 > system.l2_center).to(l2.dtype)
        diff_to_clip = diff_to_clip + k_eff * (l2 - clipped_l2)
    if dynamic or system.lz_penalty:
        lz_penalty = torch.tensor(system.lz_penalty, dtype=el.real.dtype, device=el.device)
        if system.l2_adaptive and k_eff is not None:
            lz_penalty = torch.maximum(lz_penalty, 3.0 * system.lz_center * k_eff)
        lz_square = other_observables["angular_momentum_z_square"]
        lz = other_observables["angular_momentum_z"]
        clipped_lz_square = nanmean(iqr_clip_real(lz_square))
        clipped_lz = nanmean(iqr_clip_real(lz))
        diff_to_clip = diff_to_clip + lz_penalty * (
            (lz_square - clipped_lz_square) - 2 * system.lz_center * (lz - clipped_lz)
        )
    diff = iqr_clip(diff_to_clip)
    variance = nanmean(el.real**2) - loss.real**2
    stats = LossStats(**mean_observables, energy=loss, variance=variance)
    return stats, diff


def make_loss_fn(model, system: System, mode: LossMode = LossMode.ENERGY_DIFF):
    """``loss_fn(data) -> (stats, diff)`` for ``mode = ENERGY_DIFF``."""
    if mode != LossMode.ENERGY_DIFF:
        raise NotImplementedError(
            f"{mode} is not ported yet: ROADMAP queue 1, item 'Training with Adam'."
        )
    local_energy = forward_laplacian_local_energy(model, system)

    def loss_fn(data: torch.Tensor):
        with torch.no_grad():
            el, other_observables = local_energy(data)
            return stats_and_clipped_diff(system, el, other_observables)

    return loss_fn
