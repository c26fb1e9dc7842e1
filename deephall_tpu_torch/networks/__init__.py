"""Wavefunction factory (port of ``deephall_tpu/networks/__init__.py``)."""

from torch import nn

from deephall_tpu_torch.config import Network, NetworkType, System
from deephall_tpu_torch.networks.laughlin import Laughlin
from deephall_tpu_torch.networks.psiformer import Psiformer


def make_network(system: System, network: Network) -> nn.Module:
    if network.type == NetworkType.laughlin:
        return Laughlin(nspins=tuple(system.nspins), flux=system.flux,
                        excitation_lz=system.lz_center)
    if network.type == NetworkType.psiformer:
        return Psiformer(
            nspins=tuple(system.nspins),
            flux=system.flux,
            ndets=network.psiformer.determinants,
            num_heads=network.psiformer.num_heads,
            heads_dim=network.psiformer.heads_dim,
            num_layers=network.psiformer.num_layers,
            orbital_type=network.orbital,
        )
    raise ValueError(f"Unknown network type {network.type}")
