"""Clipped-energy statistics and the energy gradient (port of ``deephall_tpu/loss.py``).

IQR clipping of the local energy (real and imaginary parts separately, median
+- 100 IQR), the optional Lz / L^2 penalty terms folded into the per-walker
differences, and NaN-resistant means for the logged statistics.

The gradient modes take the local energy under ``no_grad`` (through the jet
kernels) and one float32 forward of ``log psi`` with autograd:
``ENERGY_GRAD`` is one backward of ``sum(w.real Re log psi + w.imag Im log psi)``
with ``w = vjp_weights(diff)``, ``SR_F_VECTOR`` adds the imaginary part from a
second backward under ``(w.imag, -w.real)``, and
:func:`make_loss_and_capture_fn` runs the forward inside
:func:`~deephall_tpu_torch.networks.blocks.kfac_capture` and takes the
exact-Fisher output sensitivities from a second backward under the cotangent
``(sqrt 2, 0)`` on ``(Re, Im)``.  Gradients are ``{dotted.name: tensor}`` in
the model's parameter order.

Excited states: every loss takes ``fixed_states``, callables ``data -> log
phi_j`` of converged lower states, whose overlap penalties fold into the
per-walker differences (:func:`orthogonality_stats_and_diff`).  ``ENERGY_DIFF``
takes the current ``log psi`` from one extra forward without gradients; the
gradient modes take it from the forward that autograd already holds.

Over several ranks (:mod:`deephall_tpu_torch.parallel`) the walkers are this
rank's shard and every statistic is global: means reduce their sums and
non-NaN counts, the clip takes its quantiles on the gathered array, the
overlap's shift is the largest value over the ranks, and each rank's backward
pass gives a partial gradient (its weights divide by the global count) that
one collective sums.  Without a process group none of these makes a call.
"""

from __future__ import annotations

import enum

import torch

from deephall_tpu_torch import parallel, tracing
from deephall_tpu_torch.config import System
from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy, local_energy
from deephall_tpu_torch.networks.blocks import FISHER_COTANGENT, kfac_capture
from deephall_tpu_torch.networks.psiformer import Psiformer
from deephall_tpu_torch.types import LossStats

# The dtype of the full-Hessian local energy (every network but the Psiformer).
HESSIAN_DTYPE = torch.float64


def nanmean(x: torch.Tensor, dim: int | None = None) -> torch.Tensor:
    """Mean over the entries that are not NaN (either part, for complex input)
    and over every rank's walkers; over ``dim`` with the dimension kept, if
    given.  The sum and the count are ``torch.nanmean``'s own."""
    valid = ~torch.isnan(x)
    sums = {} if dim is None else {"dim": dim, "keepdim": True}
    if x.is_complex():
        total = torch.where(valid, x, torch.zeros_like(x)).sum(**sums)
    else:
        total = torch.nansum(x, **sums)
    total, count = parallel.all_reduce_sum(total, valid.sum(**sums).to(total.real.dtype))
    return total / count


def _clip_bounds(everything: torch.Tensor, scale: float):
    q1 = torch.nanquantile(everything, 0.25)
    q3 = torch.nanquantile(everything, 0.75)
    iqr = q3 - q1
    return q1 - scale * iqr, q3 + scale * iqr


def iqr_clip_real(x: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """``x`` clamped to the median +- ``scale`` IQR of every rank's walkers."""
    return torch.clamp(x, *_clip_bounds(parallel.all_gather_rows(x), scale))


def iqr_clip(x: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    """The real and imaginary parts clipped apart (one gather for both)."""
    everything = parallel.all_gather_rows(x)
    return torch.complex(torch.clamp(x.real, *_clip_bounds(everything.real, scale)),
                         torch.clamp(x.imag, *_clip_bounds(everything.imag, scale)))


def orthogonality_stats_and_diff(
    log_ratios: torch.Tensor, penalty
) -> tuple[torch.Tensor, torch.Tensor]:
    """Overlap penalties against fixed lower states, from one walker ensemble.

    ``O_j = |E[rho_j]|^2 / E[|rho_j|^2]`` with ``rho_j,i = phi_j(x_i) / psi(x_i)``
    over the ``|psi|^2`` walkers; its gradient folds into the differences as
    ``penalty * (conj(r) rho_i / n - O_j)`` with ``r = E[rho]``, ``n =
    E[|rho|^2]`` (``deephall_tpu/loss.py:orthogonality_stats_and_diff`` derives
    it).  The real parts are shifted by their largest value (NaN or infinite
    shifts become 0), which leaves ``O`` unchanged and keeps ``exp`` finite.

    Args:
        log_ratios: ``[n_states, batch]`` complex ``log(phi_j / psi)``.
        penalty: the strength, a float or a 0-d tensor.

    Returns:
        ``(overlap, diff)``: the real ``sum_j O_j`` and the complex per-walker
        weights ``[batch]``.
    """
    log_ratios = log_ratios.detach()
    real = log_ratios.real
    shift = torch.where(torch.isnan(real), -torch.inf, real).amax(dim=1, keepdim=True)
    # One shift for every rank's walkers: a shift per rank would not cancel.
    shift = parallel.all_reduce_max(shift)
    shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
    rho = torch.exp(log_ratios - shift)
    r = nanmean(rho, dim=1)
    n = nanmean(rho.abs() ** 2, dim=1)
    overlap = r.abs() ** 2 / n  # [n_states, 1]
    diff = penalty * (torch.conj(r) * rho / n - overlap)
    return overlap.sum(), diff.sum(dim=0)


def fixed_state_log_ratios(fixed_states, logpsi: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """``[n_states, batch]`` complex ``log(phi_j(x_i) / psi(x_i))``, without
    gradients; the span ``fixed_states``."""
    with torch.no_grad(), tracing.span("fixed_states"):
        return torch.stack([f(data) for f in fixed_states]) - logpsi.detach()[None]


# The dynamic-penalty operands (``system.dynamic_penalties``), by config field.
PENALTY_KEYS = ("lz_penalty", "lz_center", "l2_penalty", "l2_center", "overlap_penalty")


class LossMode(enum.Enum):
    ENERGY_GRAD = enum.auto()
    ENERGY_DIFF = enum.auto()
    SR_F_VECTOR = enum.auto()


def stats_and_clipped_diff(
    system: System,
    el: torch.Tensor,
    other_observables: dict,
    log_ratios: torch.Tensor | None = None,
    penalties: dict | None = None,
) -> tuple[LossStats, torch.Tensor]:
    """Per-step statistics and the clipped per-walker energy differences.

    The Lz / L^2 penalty branches follow ``deephall_tpu/loss.py:
    stats_and_clipped_diff``, including ``l2_center`` and ``l2_adaptive``.
    ``log_ratios`` (against fixed lower states) adds the overlap penalty and
    the ``overlap`` statistic.  ``penalties`` (``system.dynamic_penalties``)
    is a dict of 0-d tensors ``{lz_penalty, lz_center, l2_penalty, l2_center,
    overlap_penalty}`` that replaces the config's values; the penalty terms are
    then assembled unconditionally (a zero strength multiplies them away).
    """
    mean_observables = {k: nanmean(v) for k, v in other_observables.items()}
    loss = nanmean(el)
    clipped_loss = nanmean(iqr_clip(el))
    diff_to_clip = el - clipped_loss
    dynamic = bool(penalties)
    values = penalties if dynamic else {k: getattr(system, k) for k in PENALTY_KEYS}
    if log_ratios is not None:
        overlap, ortho_diff = orthogonality_stats_and_diff(log_ratios, values["overlap_penalty"])
        mean_observables["overlap"] = overlap
        diff_to_clip = diff_to_clip + ortho_diff
    k_eff = None
    if (dynamic and system.compute_l2) or system.l2_penalty:
        l2 = other_observables["angular_momentum_square"]
        clipped_l2 = nanmean(iqr_clip_real(l2))
        if system.l2_adaptive:
            k_eff = values["l2_penalty"] * torch.clamp(clipped_l2 - values["l2_center"], 0.0, 1.0)
        else:
            k_eff = values["l2_penalty"] * (clipped_l2 > values["l2_center"]).to(l2.dtype)
        diff_to_clip = diff_to_clip + k_eff * (l2 - clipped_l2)
    if dynamic or system.lz_penalty:
        lz_penalty = values["lz_penalty"] if dynamic else torch.full(
            (), system.lz_penalty, dtype=el.real.dtype, device=el.device)
        lz_center = values["lz_center"]
        if system.l2_adaptive and k_eff is not None:
            lz_penalty = torch.maximum(lz_penalty, 3.0 * lz_center * k_eff)
        lz_square = other_observables["angular_momentum_z_square"]
        lz = other_observables["angular_momentum_z"]
        clipped_lz_square = nanmean(iqr_clip_real(lz_square))
        clipped_lz = nanmean(iqr_clip_real(lz))
        diff_to_clip = diff_to_clip + lz_penalty * (
            (lz_square - clipped_lz_square) - 2 * lz_center * (lz - clipped_lz)
        )
    diff = iqr_clip(diff_to_clip)
    variance = nanmean(el.real**2) - loss.real**2
    stats = LossStats(**mean_observables, energy=loss, variance=variance)
    return stats, diff


def vjp_weights(diff: torch.Tensor) -> torch.Tensor:
    """Cotangent weights ``w_i = 2 (E_L,i - E_clip) / count``; NaN walkers weigh 0.

    ``count`` is over every rank's walkers, so that the ranks' backward passes
    give partial sums of the gradient.
    """
    valid = ~torch.isnan(diff)
    count = torch.clamp(parallel.all_reduce_sum(valid.sum()), min=1)
    return torch.where(valid, torch.nan_to_num(diff), torch.zeros_like(diff)) * (2.0 / count)


def _pullback(logpsi: torch.Tensor, w_re, w_im, inputs: list, retain_graph: bool):
    """``d/d inputs`` of ``sum(w_re Re log psi + w_im Im log psi)``; unused inputs get 0."""
    out = (logpsi.real * w_re + logpsi.imag * w_im).sum()
    grads = torch.autograd.grad(out, inputs, retain_graph=retain_graph, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(inputs, grads)]


def _sum_over_ranks(grads: list) -> list:
    """The ranks' partial gradients summed, in one collective over one flat buffer."""
    if not grads:
        return grads
    out = parallel.all_reduce_sum(*grads)
    return [out] if len(grads) == 1 else list(out)


def _nan_to_num(names, grads) -> dict[str, torch.Tensor]:
    return {name: torch.nan_to_num(g) for name, g in zip(names, grads)}


def gradient_and_capture(model, system: System, data: torch.Tensor, el, other_observables,
                         fixed_states=None, penalties: dict | None = None):
    """The float32 forward of ``log psi`` in the capture context and its two backward passes.

    Returns ``(stats, grads, inputs, dy)``: the energy gradient, and every
    recorded layer's input and Fisher output sensitivity, keyed by path.
    """
    params = dict(model.named_parameters())
    with torch.enable_grad(), kfac_capture(model) as capture:
        logpsi = model(data)
    log_ratios = fixed_state_log_ratios(fixed_states, logpsi, data) if fixed_states else None
    stats, diff = stats_and_clipped_diff(system, el, other_observables, log_ratios, penalties)
    w = vjp_weights(diff)
    grads = _sum_over_ranks(
        _pullback(logpsi, w.real, w.imag, list(params.values()), retain_graph=True))
    paths = list(capture.outputs)
    fisher = torch.full_like(w.real, FISHER_COTANGENT)
    dy = _pullback(logpsi, fisher, torch.zeros_like(w.imag),
                   [capture.outputs[p] for p in paths], retain_graph=False)
    return stats, _nan_to_num(params, grads), capture.inputs, dict(zip(paths, dy))


def batched_local_energy(model, system: System):
    """``data [B, N, 2] -> (E_L, OtherObservables)``: the forward-Laplacian jet
    for the Psiformer, the full-Hessian path under ``torch.func.vmap`` for every
    other network (``deephall_tpu/loss.py:make_loss_fn``).

    The full-Hessian path runs in float64 whatever the walkers' dtype
    (:data:`HESSIAN_DTYPE`), and its energies and observables come back in
    float64.  Its kinetic energy and L^2 divide by powers of sin(theta): in
    float32 an electron at eps from a pole loses digits as 1/eps^2 (the exact
    Laughlin kinetic energy 3 read 68 at eps = 1e-4).  These networks have no
    trainable parameters, so no gradient runs through it.
    """
    if isinstance(model, Psiformer):
        return forward_laplacian_local_energy(model, system)
    hessian = torch.func.vmap(local_energy(lambda x: model(x[None])[0], system))
    return lambda data: hessian(data.to(HESSIAN_DTYPE))


def make_loss_fn(model, system: System, mode: LossMode = LossMode.ENERGY_DIFF, fixed_states=None):
    """``loss_fn(data, penalties=None) -> (stats, diff_or_grads)`` for the given mode.

    ``ENERGY_DIFF`` returns the clipped per-walker differences, ``ENERGY_GRAD``
    the real gradients and ``SR_F_VECTOR`` the complex tangents, as
    ``{dotted.name: tensor}`` (empty for a network without parameters).  The
    local energy is the span ``local_energy``, a gradient mode's forward,
    statistics and backward passes the span ``gradient``.
    """
    local_energy = batched_local_energy(model, system)

    def loss_fn(data: torch.Tensor, penalties: dict | None = None):
        with torch.no_grad():
            with tracing.span("local_energy"):
                el, other_observables = local_energy(data)
            if mode == LossMode.ENERGY_DIFF:
                log_ratios = (fixed_state_log_ratios(fixed_states, model(data), data)
                              if fixed_states else None)
                return stats_and_clipped_diff(system, el, other_observables, log_ratios, penalties)
        with tracing.span("gradient"):
            return gradient(data, el, other_observables, penalties)

    def gradient(data, el, other_observables, penalties):
        params = dict(model.named_parameters())
        with torch.enable_grad():
            logpsi = model(data)
        log_ratios = fixed_state_log_ratios(fixed_states, logpsi, data) if fixed_states else None
        stats, diff = stats_and_clipped_diff(system, el, other_observables, log_ratios, penalties)
        if not params:
            return stats, {}
        w = vjp_weights(diff)
        sr = mode == LossMode.SR_F_VECTOR
        # Re[conj(grad logpsi) w] = grad(Re psi) . Re w + grad(Im psi) . Im w
        g_re = _pullback(logpsi, w.real, w.imag, list(params.values()), retain_graph=sr)
        if not sr:
            return stats, _nan_to_num(params, _sum_over_ranks(g_re))
        # Im[conj(grad logpsi) w] = grad(Re psi) . Im w - grad(Im psi) . Re w
        g_im = _pullback(logpsi, w.imag, -w.real, list(params.values()), retain_graph=False)
        both = _sum_over_ranks(g_re + g_im)
        g_re, g_im = both[:len(g_re)], both[len(g_re):]
        return stats, {
            name: torch.complex(torch.nan_to_num(a), torch.nan_to_num(b))
            for name, a, b in zip(params, g_re, g_im)
        }

    return loss_fn


def make_loss_and_capture_fn(model, system: System, fixed_states=None):
    """``fn(data, penalties=None) -> (stats, grads, inputs, dy)``: the energy gradient
    and the KFAC capture from one shared forward
    (``deephall_tpu/loss.py:make_loss_and_capture_fn``); the spans
    ``local_energy`` and ``gradient``."""
    local_energy = batched_local_energy(model, system)

    def fn(data: torch.Tensor, penalties: dict | None = None):
        with torch.no_grad(), tracing.span("local_energy"):
            el, other_observables = local_energy(data)
        with tracing.span("gradient"):
            return gradient_and_capture(model, system, data, el, other_observables,
                                        fixed_states, penalties)

    return fn
