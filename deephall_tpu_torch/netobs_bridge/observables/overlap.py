"""netobs Laughlin-overlap plugin: a thin shim over
:func:`deephall_tpu_torch.observables.estimators.make_overlap_ratios`
(``deephall_tpu/netobs_bridge/observables/overlap.py``).  ``evaluate`` returns
the per-walker ratios each step and leaves the statistics across steps to
netobs.  The module carries its parameters: ``params`` is not read."""

from __future__ import annotations

from typing import Any

import torch
from netobs.observables import Estimator, Observable

from deephall_tpu_torch.netobs_bridge.hall_system import HallSystem
from deephall_tpu_torch.observables.estimators import make_overlap_ratios


class Overlap(Observable):
    def shapeof(self, system) -> tuple[int, ...]:
        return ()


class OverlapEstimator(Estimator[HallSystem]):
    observable_type = Overlap

    def __init__(self, adaptor, system, estimator_options, observable_options):
        super().__init__(adaptor, system, estimator_options, observable_options)
        self.ratios = make_overlap_ratios(adaptor.cfg, adaptor.network)

    def empty_val_state(self, steps: int) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        device = self.adaptor.device
        return {"ratio": torch.zeros(steps, dtype=torch.complex64, device=device),
                "ratio_square": torch.zeros(steps, device=device)}, {}

    def evaluate(
        self, i, params, key, data, system, state, aux_data
    ) -> tuple[dict[str, torch.Tensor], dict[str, Any]]:
        del i, params, key, system, aux_data
        walkers = data.reshape(-1, *data.shape[-2:])
        with torch.no_grad():
            ratio, ratio_square = self.ratios(walkers)
        return {"ratio": ratio, "ratio_square": ratio_square}, state

    def digest(self, all_values, state) -> dict[str, torch.Tensor]:
        del state
        overlap = _nanmean(all_values["ratio"]).abs() ** 2 / _nanmean(all_values["ratio_square"])
        return {"overlap": overlap}


def _nanmean(x: torch.Tensor) -> torch.Tensor:
    """``jnp.nanmean``: the mean of the entries without a NaN (in either part)."""
    keep = ~torch.isnan(x)
    return torch.where(keep, x, torch.zeros_like(x)).sum() / keep.sum()


DEFAULT = OverlapEstimator
