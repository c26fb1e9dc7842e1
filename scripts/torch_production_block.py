"""The production iteration block of the PyTorch port, built one way for every tool.

The port's counterpart of ``bench.py:build_production_block``: a fresh
Psiformer (seed 42) at N=6, 2Q=15, batch 3360, KFAC with 10 Metropolis moves
an iteration, the bf16 sweep (``train.sweep_dtype``) and L^2 on or off, built
by the functions that ``train.train`` builds a fresh run with
(``train.run_generator``, ``train.fresh_walkers``, ``train.make_program``).
So one block runs the program that
``python -m deephall_tpu_torch.train`` runs with the same configuration, its
burn-in and initial-energy probe apart.  ``scripts/torch_profile_step.py``,
``scripts/torch_capture_trace.py`` and ``scripts/torch_flops_count.py`` build
on it.

    from torch_production_block import build_production_block
    cfg, block, state, generator, pmoves, t = build_production_block(compute_l2=True)
    state, pmoves, t, stats, pmove = block(state, pmoves, t, cfg.optim.block_size)

The parameters of the port live in the model, so ``state.params`` is the
model (a checkpoint holds its flax-named arrays there instead).  Nothing is
built at import.
"""

from __future__ import annotations

import sys
from pathlib import Path
from typing import NamedTuple

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

BLOCK = 10
SEED = 42


class Production(NamedTuple):
    """The pieces of the production program, each as ``train.train`` makes it."""

    cfg: object  # deephall_tpu_torch.config.Config
    model: torch.nn.Module
    generator: torch.Generator  # the run's one generator: walkers, then every sweep
    data: torch.Tensor  # [batch, nelec, 2]
    program: object  # deephall_tpu_torch.train.Program: the sweep, the step, the block
    opt_state: object  # a fresh KfacState


def production_config(compute_l2: bool, block_size: int = BLOCK, *, nelec: int = 6,
                      flux: int = 15, batch: int = 3360, num_layers: int | None = None,
                      num_heads: int | None = None, heads_dim: int | None = None):
    """The production configuration; the keywords cut it down for tests and flags."""
    from deephall_tpu_torch.config import Config

    cfg = Config()
    cfg.seed = SEED
    cfg.system.nspins = (nelec, 0)
    cfg.system.flux = flux
    cfg.system.compute_l2 = compute_l2
    cfg.batch_size = batch
    cfg.optim.optimizer = "kfac"
    cfg.optim.block_size = block_size
    widths = dict(num_layers=num_layers, num_heads=num_heads, heads_dim=heads_dim)
    for key, value in widths.items():
        if value is not None:
            setattr(cfg.network.psiformer, key, value)
    return cfg


def build_parts(compute_l2: bool, block_size: int = BLOCK, device="cuda", **overrides) -> Production:
    """The model, walkers, program and optimizer state of the block, through
    the functions with which ``train.train`` starts a fresh run.

    ``device`` ``cuda`` raises without a card; ``overrides`` are
    :func:`production_config`'s keywords.
    """
    from deephall_tpu_torch import train
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.utils import resolve_device

    cfg = production_config(compute_l2, block_size, **overrides)
    device = resolve_device(device)
    generator = train.run_generator(cfg, device)
    model = make_network(cfg.system, cfg.network)
    data = train.fresh_walkers(cfg, model, generator, device)
    model.to(device)
    program = train.make_program(cfg, model, generator)
    return Production(cfg, model, generator, data, program, program.opt_init(model, data))


def initial_state(parts: Production):
    """``(state, pmoves, t)`` before the first iteration, as ``train.train`` starts
    a fresh run: the configured width, an empty acceptance ring, ``t = 0``."""
    from deephall_tpu_torch.types import CheckpointState

    cfg, device = parts.cfg, parts.data.device
    width = torch.tensor(float(cfg.mcmc.width), dtype=torch.float32, device=device)
    state = CheckpointState(parts.model, parts.data, parts.opt_state, width)
    pmoves = torch.zeros(cfg.mcmc.adapt_frequency, dtype=torch.float32, device=device)
    return state, pmoves, torch.zeros((), dtype=torch.int32, device=device)


def build_production_block(compute_l2: bool, block_size: int = BLOCK, device="cuda", **overrides):
    """Build the production block and its initial state on ``device``.

    Returns ``(cfg, block, state, generator, pmoves, t)``: ``block(state,
    pmoves, t, length)`` runs ``length`` iterations and returns ``(state,
    pmoves, t, stats, pmove)`` (``train.make_iteration_block``); ``state`` is
    a ``CheckpointState`` whose ``params`` is the model.
    """
    parts = build_parts(compute_l2, block_size, device, **overrides)
    state, pmoves, t = initial_state(parts)
    return parts.cfg, parts.program.block, state, parts.generator, pmoves, t
