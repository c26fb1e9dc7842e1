"""Observable evaluation of stored runs (port of ``deephall_tpu/observables/runner.py``).

Restore a checkpoint and its ``config.yml`` sidecar (local paths or fsspec
URLs), walk the Metropolis chain with the float32 network, accumulate one
registered estimator on the device and save an ``.npz``.  Nothing is read back
to the host between the set-up and the digest.  Under ``torchrun`` the walkers
split over the ranks (:mod:`deephall_tpu_torch.parallel`), every rank holds
the accumulators of the whole batch, and rank 0 alone writes or prints them.

Usage::

    python -m deephall_tpu_torch.observables.runner CKPT --estimator overlap --steps 100 \\
        [--device cpu]
    torchrun --nproc_per_node=K -m deephall_tpu_torch.observables.runner CKPT ...
"""

from __future__ import annotations

import logging
import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch
import yaml

from deephall_tpu_torch import mcmc, parallel
from deephall_tpu_torch.config import Config
from deephall_tpu_torch.log import AnyPath, LogManager, init_logging
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.observables.estimators import ESTIMATORS
from deephall_tpu_torch.utils import resolve_device, set_full_precision
from deephall_tpu_torch.weights import load_flax

logger = logging.getLogger("deephall")


def load_config(ckpt_file: str | Path | AnyPath) -> Config:
    """The run configuration of the ``config.yml`` beside a checkpoint (without ``git_commit``)."""
    with (AnyPath(ckpt_file).parent / "config.yml").open() as f:
        raw = yaml.safe_load(f)
    raw.pop("git_commit", None)
    return Config.from_dict(raw)


def load_run(ckpt_file: str | Path | AnyPath):
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


def evaluate_observable(
    cfg: Config,
    model,
    params,
    data,
    mcmc_width,
    estimator_name: str,
    steps: int = 100,
    mcmc_steps: int | None = None,
    seed: int = 0,
    estimator_kwargs: dict | None = None,
    device: str | torch.device = "cuda",
) -> dict[str, np.ndarray]:
    """Walk the chain and accumulate one estimator for ``steps`` evaluations.

    ``model`` carries its parameters (``params``, the flax tree of
    :func:`load_run`, is accepted for the JAX package's signature and not
    read).  The chain samples ``|psi|^2`` of the float32 network; its width
    adapts on the device toward the [0.5, 0.55] acceptance window every
    ``max(1, min(cfg.mcmc.adapt_frequency, steps // 5))`` steps.  ``data`` is
    the global batch; in a process group each rank walks its rows of it.
    """
    del params
    device = resolve_device(device)
    set_full_precision()
    model = model.to(device)
    data = parallel.shard_rows(torch.as_tensor(data, dtype=torch.float32)).to(device)
    width = torch.tensor(float(mcmc_width), dtype=torch.float32, device=device)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)

    mcmc_step = mcmc.make_mcmc_step(model, steps=mcmc_steps or cfg.mcmc.steps)
    est = ESTIMATORS[estimator_name](cfg, model, **(estimator_kwargs or {}))
    state = est.init(steps, device)
    adapt = max(1, min(cfg.mcmc.adapt_frequency, steps // 5))
    pmoves = torch.zeros(adapt, device=device)
    with torch.no_grad():
        for i in range(steps):
            data, pmove = mcmc_step(data, width, generator)
            state = est.evaluate(generator, data, state)
            width, pmoves = mcmc.adapt_width(i, width, pmoves, pmove, adapt)
            if (i + 1) % max(1, steps // 10) == 0:
                logger.info("observable %s: step %d/%d (queued)", estimator_name, i + 1, steps)
    return est.digest(state, steps)


def cli(argv: list[str] | None = None) -> dict[str, np.ndarray]:
    """Command-line entry for observable evaluation; returns the results."""
    parser = ArgumentParser(prog="deephall-tpu-torch-observe")
    parser.add_argument("ckpt", help="checkpoint .npz path or fsspec URL")
    parser.add_argument("--estimator", required=True, choices=sorted(ESTIMATORS))
    parser.add_argument("--steps", type=int, default=100)
    parser.add_argument("--mcmc-steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default=None, help="output .npz (default: print)")
    parser.add_argument(
        "--ed-state", type=int, default=0,
        help="ed_overlap only: ED eigenstate index within the target Lz block "
        "(chained sector states)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda, which is cuda:LOCAL_RANK under torchrun)")
    parser.add_argument(
        "--backend", choices=parallel.BACKENDS, default=None,
        help="torch.distributed backend under torchrun (default: nccl on CUDA, gloo on the "
        "CPU); gloo runs several ranks on one card")
    args = parser.parse_args(argv if argv is not None else sys.argv[1:])

    init_logging()
    device = parallel.initialize_distributed(args.device, args.backend)
    cfg, model, params, data, width = load_run(args.ckpt)
    estimator_kwargs = {"state": args.ed_state} if args.estimator == "ed_overlap" else None
    results = evaluate_observable(
        cfg, model, params, data, width, args.estimator, args.steps, args.mcmc_steps,
        args.seed, estimator_kwargs=estimator_kwargs, device=device,
    )
    if parallel.rank() != 0:  # the accumulators are the same on every rank
        return results
    if args.out:
        np.savez(args.out, **results)
        logger.info("Saved %s", args.out)
    else:
        for key, value in results.items():
            print(key, np.asarray(value))
    return results


if __name__ == "__main__":
    cli()
