"""Optimizer dispatch (port of ``deephall_tpu/optimizers/__init__.py``).

Every step has the interface ``step(CheckpointState) -> (CheckpointState,
stats)``: it reads the walkers and the optimizer state from the state, updates
the model's parameters in place and returns the new optimizer state.  Over
several ranks the losses return the statistics and the gradient of the whole
batch, so every rank takes the same step on its replicas of the parameters and
of the state, and they stay equal bit for bit.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from deephall_tpu_torch.config import Config, OptimizerName
from deephall_tpu_torch.loss import LossMode, make_loss_and_capture_fn, make_loss_fn
from deephall_tpu_torch.optimizers.adam import make_adam_training_step
from deephall_tpu_torch.optimizers.kfac import make_kfac_training_step
from deephall_tpu_torch.optimizers.none import make_inference_step
from deephall_tpu_torch.types import AdamState, KfacState

logger = logging.getLogger("deephall")


def validate_opt_state(cfg: Config, opt_state):
    """Drop a restored ``opt_state`` that does not belong to the configured optimizer.

    An Adam state resumed under KFAC (or the reverse) would fail inside the
    step, so a mismatch is dropped with a warning and the driver reinitialises
    the optimizer.  Returns ``opt_state`` if it matches, else ``None``.
    """
    if opt_state is None:
        return None
    if cfg.optim.optimizer == OptimizerName.none:
        return None  # inference keeps no state
    if cfg.optim.optimizer == OptimizerName.kfac:
        ok = isinstance(opt_state, KfacState)
    elif cfg.optim.optimizer == OptimizerName.adam:
        ok = isinstance(opt_state, AdamState)
    else:  # pragma: no cover - enum is closed
        ok = False
    if not ok:
        logger.warning(
            "Restored opt_state (%s) does not match optimizer %s; reinitialising",
            type(opt_state).__name__,
            cfg.optim.optimizer,
        )
        return None
    return opt_state


def state_to(tree, device):
    """An optimizer state with every array leaf a tensor on ``device``."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(state_to(v, device) for v in tree))
    if isinstance(tree, dict):
        return {k: state_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (np.ndarray, np.generic)):
        return torch.as_tensor(np.array(tree), device=device)
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def make_optimizer_step(cfg: Config, model, fixed_states=None):
    """Build the ``(init, step)`` pair of the configured optimizer.

    ``fixed_states``: callables ``data -> log phi_j`` of converged lower states,
    whose overlap penalties enter the loss (excited-state runs).  Every step is
    ``step(state, penalties=None)``, ``penalties`` the dynamic-penalty operands.
    """
    if cfg.optim.optimizer == OptimizerName.none:
        return make_inference_step(
            make_loss_fn(model, cfg.system, LossMode.ENERGY_DIFF, fixed_states))
    if cfg.optim.optimizer == OptimizerName.adam:
        loss_grad_fn = make_loss_fn(model, cfg.system, LossMode.ENERGY_GRAD, fixed_states)
        return make_adam_training_step(cfg.optim.adam, loss_grad_fn, model)
    if cfg.optim.optimizer == OptimizerName.kfac:
        if not any(True for _ in model.parameters()):
            # The JAX package fails here too (its curvature capture finds no layer).
            raise ValueError(
                f"KFAC cannot train the {cfg.network.type} network: it has no parameters")
        # One shared forward serves the gradient and the curvature capture.
        capture_fn = make_loss_and_capture_fn(model, cfg.system, fixed_states)
        return make_kfac_training_step(cfg.optim.kfac, capture_fn, model, sum(cfg.system.nspins))
    raise ValueError(f"Optimizer {cfg.optim.optimizer} is not implemented!")
