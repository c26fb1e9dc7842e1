"""Stored runs as models (port of ``deephall_tpu/observables/runner.py:load_run``).

The estimators, the Metropolis chain of the runner and its CLI are not ported
yet (ROADMAP queue 1, "Observables and the runner, with fsspec paths").
"""

from __future__ import annotations

from pathlib import Path

import yaml

from deephall_tpu_torch.config import Config
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.weights import load_flax


def load_config(ckpt_file: str | Path) -> Config:
    """The run configuration of the ``config.yml`` beside a checkpoint (without ``git_commit``)."""
    raw = yaml.safe_load((Path(ckpt_file).parent / "config.yml").read_text())
    raw.pop("git_commit", None)
    return Config.from_dict(raw)


def load_run(ckpt_file: str | Path):
    """Restore a checkpoint and its run configuration.

    Returns:
        ``(cfg, model, params, data, mcmc_width)``: ``model`` is a float32
        module on the CPU with the checkpoint's parameters (none for the
        Laughlin / CF state, whose ``params`` are empty), ``params`` their
        flax tree of NumPy arrays, ``data`` the stored walkers.
    """
    cfg = load_config(ckpt_file)
    model = make_network(cfg.system, cfg.network)
    _, state, _ = LogManager.restore_checkpoint(ckpt_file)
    load_flax(model, state.params)
    return cfg, model, state.params, state.data, state.mcmc_width
