"""Spherical geometry helpers (port of ``deephall_tpu/geometry.py``).

Electron configurations are ``data[..., nelec, 2] = (theta, phi)`` on the unit
sphere, threaded by a magnetic monopole of strength ``Q = flux / 2``.
"""

from __future__ import annotations

import torch


def to_cartesian(theta: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Unit-sphere Cartesian coordinates, stacked on the last axis as (x, y, z)."""
    sin_t = torch.sin(theta)
    return torch.stack(
        [sin_t * torch.cos(phi), sin_t * torch.sin(phi), torch.cos(theta)], dim=-1
    )


def spinors(theta: torch.Tensor, phi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Monopole spinor coordinates ``u, v`` on the sphere.

    u = cos(theta/2) e^{+i phi/2},  v = sin(theta/2) e^{-i phi/2}
    """
    u = torch.cos(theta / 2) * torch.exp(0.5j * phi)
    v = torch.sin(theta / 2) * torch.exp(-0.5j * phi)
    return u, v


def pairwise_cos(data: torch.Tensor) -> torch.Tensor:
    """Cosine of the angle between every electron pair: ``[..., nelec, nelec]``."""
    xyz = to_cartesian(data[..., 0], data[..., 1])
    return torch.einsum("...ia,...ja->...ij", xyz, xyz)


def chord_distances(data: torch.Tensor) -> torch.Tensor:
    """Pairwise chord distances on the unit sphere with a zero diagonal."""
    xyz = to_cartesian(data[..., 0], data[..., 1])
    diff = xyz[..., None, :, :] - xyz[..., :, None, :]
    nelec = diff.shape[-2]
    eye = torch.eye(nelec, dtype=data.dtype, device=data.device)
    # The identity on the diagonal keeps the norm's argument nonzero; the
    # diagonal is zeroed again afterwards.
    safe = diff + eye[..., None]
    return torch.linalg.vector_norm(safe, dim=-1) * (1.0 - eye)
