"""netobs pair-correlation plugin: a thin shim over
:func:`deephall_tpu_torch.observables.estimators.pair_histogram`
(``deephall_tpu/netobs_bridge/observables/pair_corr.py``), with its 1e-6 floor of sin."""

from __future__ import annotations

from typing import Any

import torch
from netobs.observables import Estimator, Observable

from deephall_tpu_torch.netobs_bridge.hall_system import HallSystem
from deephall_tpu_torch.observables.estimators import pair_histogram


class PairCorrelation(Observable):
    def shapeof(self, system) -> tuple[int, ...]:
        return ()


class PairCorrelationEstimator(Estimator[HallSystem]):
    observable_type = PairCorrelation

    def __init__(self, adaptor, system, estimator_options, observable_options):
        super().__init__(adaptor, system, estimator_options, observable_options)
        self.bins = self.options.get("bins", 200)

    def empty_val_state(self, steps: int) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del steps
        return {}, {"pair_corr": torch.zeros(self.bins, device=self.adaptor.device)}

    def evaluate(
        self, i, params, key, data, system, state, aux_data
    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del i, params, key, system, aux_data
        walkers = data.reshape(-1, *data.shape[-2:])
        # Accumulated without the 1/steps normalisation, as in the reference.
        return {}, {"pair_corr": state["pair_corr"] + pair_histogram(walkers, self.bins)}

    def digest(self, all_values, state) -> dict[str, torch.Tensor]:
        del all_values, state
        return {}


DEFAULT = PairCorrelationEstimator
