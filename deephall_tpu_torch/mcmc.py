"""Metropolis-Hastings sampling of |psi|^2 on the sphere (port of ``deephall_tpu/mcmc.py``).

All-electron moves from a tangent-plane Gaussian proposal rotated to each
electron, accepted on ``2 Re log psi`` ratios.  The draws come from an explicit
``torch.Generator``; :func:`sph_sampling` and :func:`mh_update` also take the
draws as arguments, so a test can feed both packages the same numbers.
"""

from __future__ import annotations

import math
from collections.abc import Callable

import numpy as np
import torch


def sph_sampling(
    x1: torch.Tensor, stddev, normal: torch.Tensor, uniform: torch.Tensor
) -> torch.Tensor:
    """Propose new positions: polar offset ``arctan(normal * stddev)``, azimuth
    ``2 pi uniform``, rotated from the north pole onto each electron.

    Args:
        x1: current configurations ``[..., N, 2]``.
        stddev: proposal width.
        normal, uniform: draws of shape ``[..., N]``.
    """
    theta, phi = x1[..., 0], x1[..., 1]
    theta_prime = torch.arctan(normal * stddev)
    phi_prime = uniform * 2 * math.pi

    sin_tp = torch.sin(theta_prime)
    xp = sin_tp * torch.cos(phi_prime)
    yp = sin_tp * torch.sin(phi_prime)
    zp = torch.cos(theta_prime)

    # R_z(phi) @ R_y(theta) @ [xp, yp, zp], componentwise.
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    sin_p, cos_p = torch.sin(phi), torch.cos(phi)
    x_rot = cos_t * xp + sin_t * zp
    x2 = cos_p * x_rot - sin_p * yp
    y2 = sin_p * x_rot + cos_p * yp
    z2 = -sin_t * xp + cos_t * zp

    new_theta = torch.arccos(torch.clamp(z2, -1, 1))
    # sign(0) = 0, as in the JAX package.
    new_phi = torch.sign(y2) * torch.arccos(torch.clamp(x2 / torch.sin(new_theta), -1, 1))
    return torch.stack([new_theta, new_phi], dim=-1)


def mh_update(
    f: Callable[[torch.Tensor], torch.Tensor],
    x1: torch.Tensor,
    lp_1: torch.Tensor,
    stddev,
    normal: torch.Tensor,
    uniform: torch.Tensor,
    uniform_accept: torch.Tensor,
):
    """One all-electron move of the whole batch.

    Returns ``(x_new, lp_new, accept_rate)``; ``accept_rate`` is a 0-d tensor.
    """
    x2 = sph_sampling(x1, stddev, normal, uniform)
    lp_2 = 2.0 * f(x2).real
    cond = (lp_2 - lp_1) > torch.log(uniform_accept)
    x_new = torch.where(cond[..., None, None], x2, x1)
    lp_new = torch.where(cond, lp_2, lp_1)
    return x_new, lp_new, cond.float().mean()


def make_mcmc_step(batch_network: Callable[[torch.Tensor], torch.Tensor], steps: int = 10):
    """``mcmc_step(data, width, generator) -> (data, pmove)``: ``steps`` MH moves.

    ``pmove`` is the mean acceptance over the moves (a 0-d tensor on the device).
    """

    def mcmc_step(data: torch.Tensor, width, generator: torch.Generator):
        lp = 2.0 * batch_network(data).real
        accepts = torch.zeros((), device=data.device)
        shape = data.shape[:-1]
        for _ in range(steps):
            normal = torch.randn(shape, generator=generator, device=data.device)
            uniform = torch.rand(shape, generator=generator, device=data.device)
            uniform_accept = torch.rand(lp.shape, generator=generator, device=data.device)
            data, lp, rate = mh_update(
                batch_network, data, lp, width, normal, uniform, uniform_accept
            )
            accepts = accepts + rate
        return data, accepts / steps

    return mcmc_step


def update_mcmc_width(
    t: int, width: float, adapt_frequency: int, pmove: float, pmoves: np.ndarray
) -> float:
    """Adaptive proposal width: ring buffer of acceptances, updated in place.

    Every ``adapt_frequency`` steps the width grows by 1.1 when the ring's mean
    acceptance is above 0.55 and shrinks by 1.1 when it is below 0.5
    (``deephall_tpu/train.py:make_iteration_block``).
    """
    idx = t % adapt_frequency
    pmoves[idx] = pmove
    if t > 0 and idx == 0:
        mean = np.mean(pmoves, dtype=np.float32)
        # float32 arithmetic, as the width is a float32 scalar in both packages.
        if mean > 0.55:
            width = float(np.float32(width) * np.float32(1.1))
        elif mean < 0.5:
            width = float(np.float32(width) / np.float32(1.1))
    return width
