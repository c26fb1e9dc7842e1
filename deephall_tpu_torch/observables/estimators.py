"""Observable estimators: density, pair correlation, 1-RDM, overlaps, structure factor
(port of ``deephall_tpu/observables/estimators.py``).

The physics of each observable lives in a per-step function of the walkers
(and the network), and the :class:`Estimator` triple accumulates it for the
runner (``deephall_tpu_torch.observables.runner``).  Accumulators are float32
(complex64 where the JAX package keeps split real and imaginary planes) on the
walkers' device; nothing is read back to the host before ``digest``.

Histograms follow ``jnp.histogram`` exactly: float32 edges equal to
``jnp.linspace(0, pi, bins + 1)``, ``searchsorted(edges, x, side="right")``
(``torch.bucketize(..., right=True)``), the value ``pi`` in the last bin, and
values outside the range dropped through two overflow slots.  ``torch.histogram``
runs only on the CPU, ``torch.histc`` takes no weights and ``torch.bincount``
reads its input's maximum back to the host.

Over several ranks (:mod:`deephall_tpu_torch.parallel`) the walkers are this
rank's shard and each per-step function returns the value of the whole batch:
histograms and means are reduced over the ranks every step, the insertion
points and the ratios' shift are those of the whole batch, so every rank holds
the same accumulators.
"""

from __future__ import annotations

import dataclasses
import logging
import math
from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch

from deephall_tpu_torch import parallel
from deephall_tpu_torch.config import Config
from deephall_tpu_torch.geometry import pairwise_cos
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.observables.harmonics import make_monopole_harm
from deephall_tpu_torch.utils import constant

logger = logging.getLogger("deephall")

# --------------------------------------------------------------------------- #
# Per-step functions
# --------------------------------------------------------------------------- #


def histogram_edges(bins: int) -> np.ndarray:
    """The float32 edges of ``jnp.histogram(x, bins, range=(0, pi))``: ``i * (pi / bins)``
    rounded in float32, the last one ``pi`` itself."""
    pi = np.float32(math.pi)
    edges = np.arange(bins + 1, dtype=np.float32) * (pi / np.float32(bins))
    edges[-1] = pi
    return edges


def angle_histogram(
    x: torch.Tensor, bins: int, weights: torch.Tensor | None = None
) -> torch.Tensor:
    """``jnp.histogram(x, bins, range=(0, pi), weights=weights)[0]`` on ``x``'s device."""
    edges = constant(tuple(float(e) for e in histogram_edges(bins)), torch.float32, x.device)
    x = x.contiguous()
    index = torch.bucketize(x, edges, right=True)
    index = torch.where(x == edges[-1], bins, index)
    if weights is None:
        weights = torch.ones_like(x)
    # Slot 0 takes x < 0, slot bins + 1 takes x > pi; both are dropped.
    counts = torch.zeros(bins + 2, dtype=weights.dtype, device=x.device)
    return counts.index_add_(0, index, weights)[1 : bins + 1]


def density_histogram(data: torch.Tensor, bins: int) -> torch.Tensor:
    """Histogram of electron polar angles over [0, pi] (density profile), summed
    over the ranks."""
    return parallel.all_reduce_sum(angle_histogram(data[..., 0].reshape(-1), bins))


def pair_histogram(data: torch.Tensor, bins: int) -> torch.Tensor:
    """One step's normalised pair-correlation histogram g(theta_12), over every
    rank's walkers (the mean of the ranks' histograms, each over its shard).

    1/sin-weighted pairwise-angle histogram with the weight floored at sin =
    1e-6: exactly (anti)podal pairs are measure-zero but reachable in float32
    and would inject infinities (the JAX package's deliberate deviation from
    the reference, kept).
    """
    batch_size, nelec = data.shape[0], data.shape[-2]
    iu = torch.triu_indices(nelec, nelec, 1, device=data.device)
    cos12 = pairwise_cos(data)
    theta12 = torch.arccos(torch.clamp(cos12[:, iu[0], iu[1]], -1, 1)).reshape(-1)
    weights = 1 / torch.clamp(torch.sin(theta12), min=1e-6)
    hist = angle_histogram(theta12, bins, weights)
    # Factor 2 from (i != j) -> (i < j); per-step normalisation.
    return parallel.all_reduce_mean(hist * 4 * bins / batch_size / nelec**2 / math.pi)


def sample_insertion_points(generator: torch.Generator, batch: tuple[int, ...],
                            device=None) -> torch.Tensor:
    """Uniform sphere points r' used as 1-RDM insertion positions, ``[*batch, 2]``;
    ``batch`` is this rank's, the draws are those of the whole batch."""
    draws = dict(generator=generator, device=device)
    u = parallel.draw_rows(torch.rand, batch, **draws) * 2 - 1
    theta = torch.arccos(u)
    phi = (parallel.draw_rows(torch.rand, batch, **draws) * 2 - 1) * math.pi
    return torch.stack([theta, phi], dim=-1)


def make_rdm_product(cfg: Config, network) -> Callable:
    """Build the per-walker 1-RDM integrand in the LLL monopole-harmonics basis.

    For each walker R and insertion point r', computes

        4 pi * sum_a exp(log psi(R'_a) - log psi(R)) phi_i(r_a) phi_j*(r'_a)

    where R'_a replaces electron a's position with r'.  The N replaced
    configurations of every walker go through the network as one
    ``[B * N, N, 2]`` batch.

    Returns:
        ``product(data [B,N,2], r_prime [B,1,2]) -> [B, norb, norb]`` (complex).
    """
    q = cfg.system.flux / 2
    orbitals = [make_monopole_harm(q, q, m) for m in np.arange(-q, q + 1)]

    def product(data: torch.Tensor, r_prime: torch.Tensor) -> torch.Tensor:
        batch, nelec = data.shape[:2]
        eye = torch.eye(nelec, dtype=torch.bool, device=data.device)[None, :, :, None]
        data_prime = torch.where(eye, r_prime[:, None], data[:, None])  # [B, N(a), N, 2]
        logpsi = network(data)
        logpsi_prime = network(data_prime.reshape(batch * nelec, nelec, 2)).reshape(batch, nelec)
        varphi = torch.stack([orb(data) for orb in orbitals], dim=-1)  # [B, N, norb]
        varphi_prime = torch.stack([orb(r_prime[:, 0]) for orb in orbitals], dim=-1)  # [B, norb]
        wf_ratio = torch.exp(logpsi_prime - logpsi[:, None])
        # < sum_a Psi(R'_a)/Psi(R) phi_i(r_a) phi_j*(r') >
        return (4 * math.pi) * torch.einsum(
            "ba,bai,bj->bij", wf_ratio, varphi, varphi_prime.conj())

    return product


def make_overlap_ratios(cfg: Config, network) -> Callable:
    """Build the per-walker importance ratios against the analytic Laughlin state.

    overlap = |E[r]|^2 / E[|r|^2] with r = exp(log phi - log psi - shift); the
    per-step mean shift (over every rank's walkers) keeps the exponentials in
    range and cancels in the final quotient.

    Returns:
        ``ratios(data [B,N,2]) -> (ratio [B] complex, ratio_square [B])``.
    """
    laughlin = make_network(cfg.system, dataclasses.replace(cfg.network, type="laughlin"))
    return make_target_ratios(network, laughlin)


def make_target_ratios(network, target_logpsi) -> Callable:
    """Per-walker importance ratios of ``network`` against any target state.

    ``target_logpsi`` is a batched ``data -> log phi`` (the analytic Laughlin
    state, an ED eigenstate, another trained checkpoint ...).  Where its
    ``log phi`` has the wider dtype (an ED state in complex128), the
    difference is taken in it before the ``exp``.
    """

    def ratios(data: torch.Tensor):
        logpsi = network(data)
        logphi = target_logpsi(data)
        diff = logphi - logpsi
        # One shift for every rank: a shift per rank would not cancel.
        shift = parallel.all_reduce_mean(torch.mean(diff.real))
        ratio = torch.exp(diff - shift)
        return ratio, torch.abs(ratio) ** 2

    return ratios


# --------------------------------------------------------------------------- #
# Functional estimators for the runner
# --------------------------------------------------------------------------- #


class Estimator(NamedTuple):
    """An observable estimator.

    ``init(steps, device=None)`` builds the accumulator state on ``device``;
    ``evaluate(generator, data, state)`` returns the updated state after one
    walking step (the model carries its parameters, and ``generator`` draws
    whatever the estimator samples); ``digest(state, steps)`` produces the
    final named results as NumPy arrays (the only host read).
    """

    init: Callable[..., Any]
    evaluate: Callable[..., Any]
    digest: Callable[[Any, int], dict[str, np.ndarray]]


def make_density(cfg: Config, network, bins: int = 50) -> Estimator:
    """Density-profile histogram accumulator."""
    del cfg, network

    def init(steps: int, device=None):
        del steps
        return {"map": torch.zeros(bins, device=device)}

    def evaluate(generator, data, state):
        del generator
        return {"map": state["map"] + density_histogram(data, bins)}

    def digest(state, steps: int):
        del steps
        return {"map": state["map"].cpu().numpy()}

    return Estimator(init, evaluate, digest)


def make_pair_corr(cfg: Config, network, bins: int = 200) -> Estimator:
    """Pair-correlation accumulator."""
    del cfg, network

    def init(steps: int, device=None):
        del steps
        return {"pair_corr": torch.zeros(bins, device=device)}

    def evaluate(generator, data, state):
        del generator
        return {"pair_corr": state["pair_corr"] + pair_histogram(data, bins)}

    def digest(state, steps: int):
        return {"pair_corr": state["pair_corr"].cpu().numpy() / steps}

    return Estimator(init, evaluate, digest)


def make_one_rdm(cfg: Config, network) -> Estimator:
    """One-body reduced density matrix accumulator."""
    norb = cfg.system.flux + 1
    batch_product = make_rdm_product(cfg, network)

    def init(steps: int, device=None):
        del steps
        return {"one_rdm": torch.zeros((norb, norb), dtype=torch.complex64, device=device),
                "count": 0.0}

    def evaluate(generator, data, state):
        r_prime = sample_insertion_points(generator, data.shape[:1], data.device)[:, None, :]
        product = parallel.all_reduce_mean(torch.mean(batch_product(data, r_prime), dim=0))
        return {"one_rdm": state["one_rdm"] + product, "count": state["count"] + 1.0}

    def digest(state, steps: int):
        del steps
        one_rdm = state["one_rdm"].cpu().numpy().astype(np.complex128) / state["count"]
        return {"one_rdm": one_rdm, "diagonal": np.diagonal(one_rdm), "trace": np.trace(one_rdm)}

    return Estimator(init, evaluate, digest)


def make_overlap(cfg: Config, network) -> Estimator:
    """Laughlin-overlap accumulator."""
    return _overlap_estimator(make_overlap_ratios(cfg, network))


def make_ed_overlap(cfg: Config, network, state: int = 0) -> Estimator:
    """Overlap with the exact LLL eigenstate from exact diagonalization.

    Runs ``ed.ed_block`` for the configured system on the host once and
    accumulates ``|<psi_ED|psi>|^2 / (<psi_ED|psi_ED><psi|psi>)`` from the
    same walkers, the ED state evaluated in complex128.

    Sector-aware: a checkpoint trained with the Lz penalty at ``lz_center =
    m`` (the magnetoroton workflow) is compared against eigenstate ``state``
    of the matching ``Lz = m`` block.
    """
    from deephall_tpu_torch.networks.edstate import make_ed_network

    two_lz = round(2 * cfg.system.lz_center) if cfg.system.lz_penalty else 0
    ed_network, result = make_ed_network(cfg.system, state=state, two_lz=two_lz)
    logger.info(
        "ED block dim=%d (2Lz=%d), target state %d: E=%.6f (total %.6f)",
        result.dim,
        two_lz,
        state,
        result.energies[state],
        sum(cfg.system.nspins) / 2.0
        + cfg.system.interaction_strength * float(result.energies[state]),
    )
    return _overlap_estimator(make_target_ratios(network, lambda d: ed_network(d.double())))


def _masked_mean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmean`` over every rank's walkers, complex values included (a NaN
    in either part is dropped)."""
    nan = torch.isnan(x.real) | torch.isnan(x.imag) if x.is_complex() else torch.isnan(x)
    keep = ~nan
    total = torch.where(keep, x, 0).sum()
    total, count = parallel.all_reduce_sum(total, keep.sum().to(total.real.dtype))
    return total / count


def _overlap_estimator(ratios) -> Estimator:
    def init(steps: int, device=None):
        del steps
        return {
            "ratio": torch.zeros((), dtype=torch.complex64, device=device),
            "ratio_square": torch.zeros((), device=device),
            "count": 0.0,
        }

    def evaluate(generator, data, state):
        del generator
        ratio, ratio_square = ratios(data)
        return {
            "ratio": state["ratio"] + _masked_mean(ratio).to(torch.complex64),
            "ratio_square": state["ratio_square"] + _masked_mean(ratio_square).float(),
            "count": state["count"] + 1.0,
        }

    def digest(state, steps: int):
        del steps
        count = state["count"]
        ratio = complex(state["ratio"].item()) / count
        ratio_square = float(state["ratio_square"].item()) / count
        return {"overlap": np.asarray(abs(ratio) ** 2 / ratio_square)}

    return Estimator(init, evaluate, digest)


def make_structure_factor(cfg: Config, network, lmax: int = 8) -> Estimator:
    """Static structure factor multipoles ``S_L = 1 + (N-1) E_pair[P_L]``.

    Exact counterpart for ED states: ``observables.ed.structure_factor``.
    ``S_1`` obeys the exact LLL identity ``1/(Q+1) + L(L+1)/(N (Q+1)^2)``.
    """
    del network
    nelec = sum(cfg.system.nspins)

    def init(steps: int, device=None):
        del steps
        return {"p_l": torch.zeros(lmax + 1, device=device), "count": 0.0}

    def evaluate(generator, data, state):
        del generator
        return {
            "p_l": state["p_l"] + pair_legendre_means(data, lmax),
            "count": state["count"] + 1.0,
        }

    def digest(state, steps: int):
        del steps
        p_l = state["p_l"].cpu().numpy() / state["count"]
        return {"structure_factor": 1.0 + (nelec - 1) * p_l}

    return Estimator(init, evaluate, digest)


def pair_legendre_means(data: torch.Tensor, lmax: int) -> torch.Tensor:
    """``[lmax + 1]``: the mean over every rank's walkers and ordered pairs of
    ``P_L(cos theta_12)`` (``P_0`` = 1), by the three-term recurrence."""
    nelec = data.shape[-2]
    x = pairwise_cos(data)  # [B, N, N]
    mask = 1.0 - torch.eye(nelec, device=data.device)
    p_prev = torch.ones_like(x)
    p_cur = x
    means = [torch.ones((), device=data.device)]
    for lval in range(1, lmax + 1):
        means.append(torch.mean(torch.sum(p_cur * mask, (-2, -1))) / (nelec * (nelec - 1)))
        p_prev, p_cur = p_cur, ((2 * lval + 1) * x * p_cur - lval * p_prev) / (lval + 1)
    return parallel.all_reduce_mean(torch.stack(means))


ESTIMATORS = {
    "density": make_density,
    "pair_corr": make_pair_corr,
    "one_rdm": make_one_rdm,
    "overlap": make_overlap,
    "ed_overlap": make_ed_overlap,
    "structure_factor": make_structure_factor,
}
