"""Inference (no-op) optimizer: evaluate statistics, keep parameters fixed.

Port of ``deephall_tpu/optimizers/none.py``: ``ENERGY_DIFF`` mode, so no
parameter gradient is computed at all.  The statistics are those of every
rank's walkers.
"""

from __future__ import annotations

from deephall_tpu_torch.types import CheckpointState


def make_inference_step(loss_diff_fn):
    """``(init, step)``: ``init`` keeps no state; ``step(state, penalties=None) -> (state, stats)``."""

    def init(model, data):
        del model, data
        return None

    def step(state: CheckpointState, penalties: dict | None = None):
        # The operands only when present, so that plain ``(data)`` losses keep working.
        stats, _ = loss_diff_fn(state.data, penalties) if penalties else loss_diff_fn(state.data)
        return state, stats

    return init, step
