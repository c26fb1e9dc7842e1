"""netobs density plugin: a thin shim over
:func:`deephall_tpu_torch.observables.estimators.density_histogram`
(``deephall_tpu/netobs_bridge/observables/density.py``)."""

from __future__ import annotations

from typing import Any

import torch
from netobs.observables import Estimator
from netobs.observables.density import Density

from deephall_tpu_torch.netobs_bridge.hall_system import HallSystem
from deephall_tpu_torch.observables.estimators import density_histogram


class DensityEstimator(Estimator[HallSystem]):
    observable_type = Density

    def __init__(self, adaptor, system, estimator_options, observable_options):
        super().__init__(adaptor, system, estimator_options, observable_options)
        self.hist_bins = self.options.get("bins", 50)

    def empty_val_state(self, steps: int) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del steps
        return {}, {"map": torch.zeros(self.hist_bins, device=self.adaptor.device)}

    def evaluate(
        self, i, params, key, data, system, state, aux_data
    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del i, params, key, system, aux_data
        walkers = data.reshape(-1, *data.shape[-2:])
        return {}, {"map": state["map"] + density_histogram(walkers, self.hist_bins)}

    def digest(self, all_values, state) -> dict[str, torch.Tensor]:
        del all_values, state
        return {}


DEFAULT = DensityEstimator
