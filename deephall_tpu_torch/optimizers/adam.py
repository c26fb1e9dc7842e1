"""Adam (port of ``deephall_tpu/optimizers/adam.py``, which is ``optax.adam``).

``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``, ``eps_root = 0``; the moments are
bias-corrected with ``count + 1`` and the learning rate is the schedule at the
count before the increment, as optax's ``scale_by_adam`` and
``scale_by_learning_rate`` compute them.  Parameters are updated in place, so
their ``Tensor._version`` moves and the attention kernels' prepared weights are
rebuilt (``ops/jet_attention.py:prepare_weights``).  The gradient is that of
the whole batch (summed over the ranks by the loss), so every rank's update is
the same.
"""

from __future__ import annotations

import torch

from deephall_tpu_torch import tracing
from deephall_tpu_torch.config import OptimizerAdam
from deephall_tpu_torch.types import AdamState, CheckpointState
from deephall_tpu_torch.weights import flatten, nest

B1, B2, EPS = 0.9, 0.999, 1e-8


def make_adam_training_step(optim_cfg: OptimizerAdam, loss_grad_fn, model):
    """``(init, step)``; ``loss_grad_fn(data, penalties) -> (stats, grads)`` (``ENERGY_GRAD``);
    the parameter update is the span ``update`` (:mod:`deephall_tpu_torch.tracing`)."""
    params = dict(model.named_parameters())

    def zeros() -> dict:
        return {"params": nest({k: torch.zeros_like(p) for k, p in params.items()})}

    def init(model, data) -> AdamState:
        del model
        # A network without parameters (the Laughlin state) keeps its count
        # beside the walkers.
        device = next(iter(params.values())).device if params else data.device
        return AdamState(torch.zeros((), dtype=torch.int32, device=device), zeros(), zeros())

    def step(state: CheckpointState, penalties: dict | None = None):
        stats, grads = loss_grad_fn(state.data, penalties) if penalties else loss_grad_fn(state.data)
        opt = state.opt_state
        with torch.no_grad(), tracing.span("update"):
            count = opt.count + 1
            lr = optim_cfg.lr.schedule(opt.count)
            mu_old, nu_old = flatten(opt.mu), flatten(opt.nu)
            mu, nu = {}, {}
            for name, p in params.items():
                g = grads[name]
                mu[name] = (1 - B1) * g + B1 * mu_old[name]
                nu[name] = (1 - B2) * (g * g) + B2 * nu_old[name]
                mu_hat = mu[name] / (1 - B1**count)
                nu_hat = nu[name] / (1 - B2**count)
                p.sub_(lr * (mu_hat / (torch.sqrt(nu_hat) + EPS)))
        new_opt = AdamState(count, {"params": nest(mu)}, {"params": nest(nu)})
        return state._replace(opt_state=new_opt), stats

    return init, step
