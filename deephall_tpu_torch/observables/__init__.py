"""Observable estimation on stored runs (port of ``deephall_tpu/observables``).

Density profile, pair correlation, one-body RDM, Laughlin and ED overlaps and
the structure factor, with a checkpoint-driven runner.
"""

from deephall_tpu_torch.observables.estimators import (
    ESTIMATORS,
    Estimator,
    make_density,
    make_one_rdm,
    make_overlap,
    make_pair_corr,
)
from deephall_tpu_torch.observables.runner import evaluate_observable, load_run

__all__ = [
    "ESTIMATORS",
    "Estimator",
    "evaluate_observable",
    "load_run",
    "make_density",
    "make_one_rdm",
    "make_overlap",
    "make_pair_corr",
]
