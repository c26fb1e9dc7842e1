"""A fresh run's first checkpoint, written before any optimizer step.

    python scripts/torch_fresh_checkpoint.py key=value ... [--yml file] [--device cuda]

The configuration is read as ``python -m deephall_tpu_torch.train`` reads it,
and the run starts as ``train.train`` starts a fresh one: the parameters from
``seed`` and the walkers from the run's generator (``train.fresh_walkers``),
the program of ``train.make_program`` and its optimizer state as
``opt_init`` makes it, then ``mcmc.burn_in`` sweeps at ``mcmc.width``.
``log.LogManager.save_checkpoint`` then writes ``ckpt_000000.npz`` under
``log.save_path``, beside the run's ``config.yml``: the parameters, the
burnt-in walkers, the optimizer state (KFAC's factors and weight zero), the
width and an empty acceptance ring.  The CLI restores it as a run at step 1
that needs no burn-in.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv: list[str] | None = None) -> Path:
    from deephall_tpu_torch import train
    from deephall_tpu_torch.config import (
        Config,
        dotlist_to_dict,
        merge_dicts,
        resolve_interpolations,
        to_dict,
    )
    from deephall_tpu_torch.log import LogManager, init_logging
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.types import CheckpointState
    from deephall_tpu_torch.weights import params_to_flax

    parser = ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("dotlist", nargs="*", help="path.to.key=value pairs, as the CLI takes them")
    parser.add_argument("--yml", help="config YML file to merge")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    tree = to_dict(Config())
    if args.yml:
        import yaml

        with open(args.yml, encoding="utf8") as f:
            tree = merge_dicts(tree, yaml.safe_load(f) or {})
    cfg = Config.from_dict(resolve_interpolations(merge_dicts(tree, dotlist_to_dict(args.dotlist))))

    init_logging()
    device = torch.device(args.device)
    log_manager = LogManager(cfg)
    generator = train.run_generator(cfg, device)
    model = make_network(cfg.system, cfg.network)
    data = train.fresh_walkers(cfg, model, generator, device)
    model.to(device)
    program = train.make_program(cfg, model, generator)
    opt_state = program.opt_init(model, data)
    width = torch.tensor(float(cfg.mcmc.width), dtype=torch.float32, device=device)
    with torch.no_grad():
        for _ in range(cfg.mcmc.burn_in):
            data, _ = program.mcmc_step(data, width, generator)
    log_manager.save_checkpoint(
        0, CheckpointState(params_to_flax(model), data, opt_state, width.item()),
        adapt={"pmoves": np.zeros(cfg.mcmc.adapt_frequency, dtype=np.float32), "t": np.int32(0)})
    return Path(str(log_manager.save_path)) / "ckpt_000000.npz"


if __name__ == "__main__":
    print(main())
