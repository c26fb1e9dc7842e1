"""Psiformer attention wavefunction on the monopole sphere.

Port of ``deephall_tpu/networks/psiformer.py``: Cartesian + spin input
features, a stack of attention blocks with LayerNorms and tanh-MLP residuals,
complex orbitals against the monopole-harmonics envelope, a two-channel Jastrow
factor and a signed log-sum of determinants.  Submodules carry the flax names
(``PsiformerLayers_0``, ``MultiHeadAttention_1``, ``Dense_3``, ...).
"""

from __future__ import annotations

import torch
from torch import nn

from deephall_tpu_torch.config import OrbitalType
from deephall_tpu_torch.networks.blocks import (
    Dense,
    Jastrow,
    LayerNorm,
    MultiHeadAttention,
    Orbitals,
)
from deephall_tpu_torch.ops.slogdet import signed_logsumdet


def spin_values(nspins: tuple[int, int]) -> list[float]:
    return [1.0] * nspins[0] + [-1.0] * nspins[1]


def input_feature(theta: torch.Tensor, phi: torch.Tensor, spins: torch.Tensor):
    return torch.stack(
        [
            torch.cos(theta),
            torch.sin(theta) * torch.cos(phi),
            torch.sin(theta) * torch.sin(phi),
            torch.broadcast_to(spins, theta.shape),
        ],
        dim=-1,
    )


class PsiformerLayers(nn.Module):
    """Attention feature tower over the electron axis."""

    def __init__(self, num_heads: int, heads_dim: int, num_layers: int):
        super().__init__()
        self.num_heads = num_heads
        self.num_layers = num_layers
        dim = num_heads * heads_dim
        self.add_module("Dense_0", Dense(4, dim, use_bias=False))
        for i in range(num_layers):
            self.add_module(f"MultiHeadAttention_{i}", MultiHeadAttention(dim, num_heads))
            self.add_module(f"Dense_{2 * i + 1}", Dense(dim, dim, use_bias=False))
            self.add_module(f"LayerNorm_{2 * i}", LayerNorm(dim))
            self.add_module(f"Dense_{2 * i + 2}", Dense(dim, dim))
            self.add_module(f"LayerNorm_{2 * i + 1}", LayerNorm(dim))

    def layer(self, name: str) -> nn.Module:
        return getattr(self, name)

    def forward(
        self, electrons: torch.Tensor, spins: torch.Tensor, dtype: torch.dtype | None = None
    ) -> torch.Tensor:
        """Tower features ``[..., N, D]`` in the dtype of ``electrons``.

        ``dtype`` (e.g. ``torch.bfloat16``) runs the attention stack in reduced
        precision; the result is cast back for the orbital head.
        """
        h = input_feature(electrons[..., 0], electrons[..., 1], spins)
        if dtype is not None:
            h = h.to(dtype)
        h = self.layer("Dense_0")(h)
        for i in range(self.num_layers):
            attn = self.layer(f"MultiHeadAttention_{i}")(h)
            h = h + self.layer(f"Dense_{2 * i + 1}")(attn)
            h = self.layer(f"LayerNorm_{2 * i}")(h)
            h = h + torch.tanh(self.layer(f"Dense_{2 * i + 2}")(h))
            h = self.layer(f"LayerNorm_{2 * i + 1}")(h)
        return h.to(electrons.dtype)


class Psiformer(nn.Module):
    """``forward(electrons[..., N, 2]) -> log psi [...]`` (complex)."""

    def __init__(
        self,
        nspins: tuple[int, int],
        flux: int,
        ndets: int,
        num_heads: int,
        heads_dim: int,
        num_layers: int,
        orbital_type: OrbitalType,
    ):
        super().__init__()
        self.nspins = tuple(nspins)
        self.flux = flux
        self.Q = flux / 2
        self.ndets = ndets
        self.num_heads = num_heads
        self.heads_dim = heads_dim
        self.num_layers = num_layers
        self.orbital_type = OrbitalType(orbital_type)
        self.add_module(
            "PsiformerLayers_0", PsiformerLayers(num_heads, heads_dim, num_layers)
        )
        self.add_module(
            "Orbitals_0",
            Orbitals(num_heads * heads_dim, orbital_type, flux, nspins, ndets),
        )
        self.add_module("Jastrow_0", Jastrow(nspins))
        self.register_buffer(
            "spins", torch.tensor(spin_values(self.nspins)), persistent=False
        )

    def orbitals(self, electrons: torch.Tensor, dtype: torch.dtype | None = None):
        theta, phi = electrons[..., 0], electrons[..., 1]
        h_one = self.PsiformerLayers_0(electrons, self.spins, dtype)
        orbitals = self.Orbitals_0(h_one, theta, phi)
        jastrow = self.Jastrow_0(electrons)
        return torch.exp(jastrow / sum(self.nspins))[..., None, None, None] * orbitals

    def forward(self, electrons: torch.Tensor, dtype: torch.dtype | None = None):
        return signed_logsumdet(self.orbitals(electrons, dtype))
