"""Shared containers (port of ``deephall_tpu/types.py``).

Statistics are plain dicts of tensors keyed as in the JAX package; the
checkpoint state is a NamedTuple with the same four fields.
"""

from __future__ import annotations

from typing import Any, NamedTuple, TypedDict

import torch


class AngularMomenta(TypedDict):
    """Angular momenta, computed alongside the kinetic energy."""

    angular_momentum_z: torch.Tensor
    angular_momentum_z_square: torch.Tensor
    angular_momentum_square: torch.Tensor


class OtherObservables(AngularMomenta):
    """Everything else produced while computing the local energy."""

    kinetic: torch.Tensor
    potential: torch.Tensor


class LossStats(OtherObservables):
    """Per-step statistics (batch means)."""

    energy: torch.Tensor
    variance: torch.Tensor


class CheckpointState(NamedTuple):
    """What a checkpoint holds.

    ``params`` is the flax-named nested dict of NumPy arrays (see
    :mod:`deephall_tpu_torch.weights`), ``data`` the walkers ``[batch, nelec, 2]``,
    ``opt_state`` the optimizer state (``None`` for inference) and
    ``mcmc_width`` the proposal width.
    """

    params: Any
    data: Any
    opt_state: Any
    mcmc_width: Any
