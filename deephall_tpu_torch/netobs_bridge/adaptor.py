"""netobs ``NetworkAdaptor`` for the port's checkpoints (``deephall_tpu/netobs_bridge/adaptor.py``).

The method names and their values are netobs's, with torch tensors in and out
on the adaptor's device (``cuda`` unless the adaptor's arguments hold
``--device cpu``).  ``params`` is the restored module's
``state_dict()``; every method that takes it evaluates the module with it
(``torch.func.functional_call``).  Per-configuration methods take one
``[nelec, 2]`` configuration; batch them with ``torch.func.vmap``.  A key is a
``torch.Generator`` on that device.

The kinetic energy is the full-Hessian one (``hamiltonian.make_local_kinetic_energy``),
as in the JAX adaptor.  For the analytic networks (Laughlin / composite
fermion, ED state) it runs in float64, as the port's loss does
(``loss.HESSIAN_DTYPE``): in float32 an electron near a pole loses digits
as 1/eps^2.
"""

from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any, TypedDict

import torch
from netobs.adaptors import NetworkAdaptor, WalkingStep

from deephall_tpu_torch import mcmc
from deephall_tpu_torch.hamiltonian import make_local_kinetic_energy, make_potential
from deephall_tpu_torch.loss import HESSIAN_DTYPE
from deephall_tpu_torch.netobs_bridge.hall_system import HallSystem
from deephall_tpu_torch.networks.psiformer import Psiformer
from deephall_tpu_torch.observables.runner import load_run
from deephall_tpu_torch.utils import resolve_device, set_full_precision


class DeepHallAuxData(TypedDict):
    mcmc_width: torch.Tensor


def _device_from_args(args: list[str] | None) -> str:
    args = list(args or [])
    if "--device" in args and args.index("--device") + 1 < len(args):
        return args[args.index("--device") + 1]
    return "cuda"


class DeepHallAdaptor(NetworkAdaptor[HallSystem]):
    """Expose a trained run of the port to the netobs analysis CLI."""

    def __init__(self, config: Any, args: list[str]) -> None:
        super().__init__(config, args)
        self.device = _device_from_args(args)

    def restore(
        self, ckpt_file: str | None = None
    ) -> tuple[dict[str, torch.Tensor], torch.Tensor, HallSystem, DeepHallAuxData]:
        """Rebuild the network and the sampler's state from a checkpoint and its config.yml.

        Args:
            ckpt_file: a ``ckpt_*.npz`` path or fsspec URL (its directory holds
                the ``config.yml`` that every training run writes).

        Raises:
            ValueError: if no checkpoint is given.
            RuntimeError: if the device is ``cuda`` and there is no card.

        Returns:
            ``(params, walkers, system, aux_data)``, netobs's restore contract.
        """
        if ckpt_file is None:
            raise ValueError("Must specify a checkpoint")
        self.device = device = resolve_device(self.device)
        set_full_precision()
        cfg, model, _, data, mcmc_width = load_run(str(ckpt_file))
        self.cfg = cfg
        self.network = model.to(device).requires_grad_(False)
        self.hessian_dtype = None if isinstance(model, Psiformer) else HESSIAN_DTYPE
        self.Q = cfg.system.flux / 2
        self.radius = cfg.system.radius if cfg.system.radius is not None else math.sqrt(self.Q)
        self.potential_energy = make_potential(cfg.system.interaction_type, self.Q, self.radius)
        system = HallSystem(spins=list(cfg.system.nspins), ndim=2, flux=cfg.system.flux)
        aux = DeepHallAuxData(
            mcmc_width=torch.tensor(float(mcmc_width), dtype=torch.float32, device=device))
        params = dict(self.network.state_dict())
        walkers = torch.as_tensor(data, dtype=torch.float32).to(device)
        return params, walkers, system, aux

    def _log_psi(self, params: dict[str, torch.Tensor], electrons: torch.Tensor) -> torch.Tensor:
        """``log psi`` of one configuration ``[nelec, 2]`` with ``params``."""
        return torch.func.functional_call(self.network, params, (electrons[None],))[0]

    def call_signed_network(
        self, params: dict[str, torch.Tensor], electrons: torch.Tensor, system: HallSystem
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """Log-wavefunction with a trivial sign (log psi is already complex)."""
        del system
        return torch.ones((), device=electrons.device), self._log_psi(params, electrons)

    def make_walking_step(
        self, batch_log_psi: Callable, steps: int, system: HallSystem
    ) -> WalkingStep[DeepHallAuxData]:
        """``walk(key, params, electrons, aux_data)``: ``steps`` Metropolis moves
        of the port's sampler; the width is kept."""

        def walk(
            key: torch.Generator,
            params: dict[str, torch.Tensor],
            electrons: torch.Tensor,
            aux_data: DeepHallAuxData,
        ) -> tuple[torch.Tensor, DeepHallAuxData]:
            step = mcmc.make_mcmc_step(lambda x: batch_log_psi(params, x, system), steps=steps)
            with torch.no_grad():
                moved, _pmove = step(electrons, aux_data["mcmc_width"], key)
            return moved, aux_data

        return walk

    def call_local_kinetic_energy(
        self,
        params: dict[str, torch.Tensor],
        key: torch.Generator | None,
        electrons: torch.Tensor,
        system: HallSystem,
    ) -> torch.Tensor:
        """Monopole kinetic energy of one configuration (observables discarded)."""
        del key, system
        if self.hessian_dtype is not None:
            electrons = electrons.to(self.hessian_dtype)
        ke = make_local_kinetic_energy(lambda x: self._log_psi(params, x), self.Q, self.radius)
        kinetic, _observables = ke(electrons)
        return kinetic

    def call_local_potential_energy(
        self,
        params: dict[str, torch.Tensor],
        key: torch.Generator | None,
        electrons: torch.Tensor,
        system: HallSystem,
    ) -> torch.Tensor:
        """Scaled interaction energy of one configuration."""
        del params, key, system
        return self.potential_energy(electrons) * self.cfg.system.interaction_strength


DEFAULT = DeepHallAdaptor
