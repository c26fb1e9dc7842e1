"""Shared containers (port of ``deephall_tpu/types.py``).

Statistics are plain dicts of tensors keyed as in the JAX package; the
checkpoint state is a NamedTuple with the same four fields.  The optimizer
states carry the JAX package's field names (``KfacState``) and optax's
(``AdamState``, optax's ``ScaleByAdamState``), so a JAX checkpoint's state maps
onto them one to one.
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
    """Per-step statistics (batch means).

    Excited-state runs (``system.orthogonal_states``) also carry a real
    ``overlap`` key: the summed normalised overlaps with the fixed lower states.
    """

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


class KfacState(NamedTuple):
    """KFAC's curvature, as ``deephall_tpu/optimizers/kfac.py:KfacState``.

    ``kron``: ``{path: {"a": [fan_in (+1 with a bias)]^2, "g": [fan_out]^2}}``;
    ``diag``: ``{path: {"scale": [f], "bias": [f]}}`` for the LayerNorms;
    ``weight``: the EMA normaliser; ``step``: the int32 step counter.  ``path``
    is the module path joined with ``/``.
    """

    kron: dict
    diag: dict
    weight: Any
    step: Any


class AdamState(NamedTuple):
    """Adam's moments, as optax's ``ScaleByAdamState``: the int32 ``count`` and
    ``mu`` / ``nu`` as flax-named trees ``{"params": {...}}``."""

    count: Any
    mu: dict
    nu: dict
