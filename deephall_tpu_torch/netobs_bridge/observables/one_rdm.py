"""netobs 1-RDM plugin: a thin shim over
:func:`deephall_tpu_torch.observables.estimators.make_rdm_product`
(``deephall_tpu/netobs_bridge/observables/one_rdm.py``).  ``evaluate`` returns
the per-walker product each step and leaves the statistics across steps to
netobs.  The module carries its parameters: ``params`` is not read."""

from __future__ import annotations

from typing import Any

import torch
from netobs.observables import Estimator, Observable

from deephall_tpu_torch.netobs_bridge.hall_system import HallSystem
from deephall_tpu_torch.observables.estimators import make_rdm_product, sample_insertion_points


class OneRDM(Observable[HallSystem]):
    def shapeof(self, system) -> tuple[int, ...]:
        norbs = system["flux"] + 1
        return (norbs, norbs)


class OneRDMEstimator(Estimator[HallSystem]):
    observable_type = OneRDM

    def __init__(self, adaptor, system, estimator_options, observable_options):
        super().__init__(adaptor, system, estimator_options, observable_options)
        self.batch_product = make_rdm_product(adaptor.cfg, adaptor.network)

    def empty_val_state(self, steps: int) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        dtype = getattr(torch, self.options.get("dtype", "complex64"))
        shape = (steps, *self.observable.shape)
        return {"one_rdm": torch.zeros(shape, dtype=dtype, device=self.adaptor.device)}, {}

    def evaluate(
        self, i, params, key, data, system, state, aux_data
    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del i, params, system, aux_data
        walkers = data.reshape(-1, *data.shape[-2:])
        r_prime = sample_insertion_points(key, walkers.shape[:1], walkers.device)[:, None, :]
        with torch.no_grad():
            return {"one_rdm": self.batch_product(walkers, r_prime)}, state

    def digest(self, all_values, state) -> dict[str, torch.Tensor]:
        del state
        one_rdm = all_values["one_rdm"].mean(dim=0)
        return {"diagonal": torch.diagonal(one_rdm), "trace": torch.trace(one_rdm)}


DEFAULT = OneRDMEstimator
