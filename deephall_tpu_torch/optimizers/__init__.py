"""Optimizer dispatch (port of ``deephall_tpu/optimizers/__init__.py``)."""

from __future__ import annotations

from deephall_tpu_torch.config import Config, OptimizerName
from deephall_tpu_torch.loss import LossMode, make_loss_fn
from deephall_tpu_torch.optimizers.none import make_inference_step

_ROADMAP = {
    OptimizerName.adam: "'Training with Adam'",
    OptimizerName.kfac: "'KFAC with its curvature capture'",
}


def make_optimizer_step(cfg: Config, model):
    """Build the ``(init, step)`` pair of the configured optimizer."""
    if cfg.optim.optimizer == OptimizerName.none:
        return make_inference_step(make_loss_fn(model, cfg.system, LossMode.ENERGY_DIFF))
    if cfg.optim.optimizer in _ROADMAP:
        raise NotImplementedError(
            f"optim.optimizer={cfg.optim.optimizer} is not ported yet: ROADMAP "
            f"queue 1, item {_ROADMAP[cfg.optim.optimizer]}."
        )
    raise ValueError(f"Optimizer {cfg.optim.optimizer} is not implemented!")
