"""Metropolis-Hastings over |psi|^2 on the sphere, in plain PyTorch, from
given draws.

DeepHall's all-electron move: each electron is moved by a polar offset
``arctan(width * normal)`` in a uniformly drawn direction ``2 pi uniform``
about its own position, and the whole move is accepted when
``2 Re log psi' - 2 Re log psi > log(uniform_accept)``.  A sweep of ``steps``
moves draws, per move, the normals ``[B, N]``, the directions ``[B, N]`` and
the acceptance uniforms ``[B]`` from one generator in that order.
"""

from __future__ import annotations

import math

import torch


def propose(x: torch.Tensor, width, normal: torch.Tensor, uniform: torch.Tensor) -> torch.Tensor:
    theta, phi = x[..., 0], x[..., 1]
    off = torch.arctan(normal * width)
    turn = uniform * 2 * math.pi
    local = torch.stack([torch.sin(off) * torch.cos(turn), torch.sin(off) * torch.sin(turn),
                         torch.cos(off)], dim=-1)
    # The offset taken from the north pole to the electron: R_z(phi) R_y(theta).
    st, ct, sp, cp = torch.sin(theta), torch.cos(theta), torch.sin(phi), torch.cos(phi)
    rot = torch.stack([
        torch.stack([cp * ct, -sp, cp * st], -1),
        torch.stack([sp * ct, cp, sp * st], -1),
        torch.stack([-st, torch.zeros_like(st), ct], -1),
    ], -2)
    xyz = (rot @ local[..., None])[..., 0]
    new_theta = torch.arccos(torch.clamp(xyz[..., 2], -1, 1))
    new_phi = torch.atan2(xyz[..., 1], xyz[..., 0])
    return torch.stack([new_theta, new_phi], dim=-1)


def sweep(logpsi_fn, x: torch.Tensor, width, generator: torch.Generator, steps: int):
    """The walkers after ``steps`` moves drawn from ``generator``."""
    device = x.device
    lp = 2 * logpsi_fn(x).real
    for _ in range(steps):
        shape = x.shape[:-1]
        normal = torch.randn(shape, generator=generator, device=device).to(x.dtype)
        uniform = torch.rand(shape, generator=generator, device=device).to(x.dtype)
        accept = torch.rand(shape[:-1], generator=generator, device=device).to(x.dtype)
        proposal = propose(x, width, normal, uniform)
        lp_new = 2 * logpsi_fn(proposal).real
        take = (lp_new - lp) > torch.log(accept)
        x = torch.where(take[..., None, None], proposal, x)
        lp = torch.where(take, lp_new, lp)
    return x
