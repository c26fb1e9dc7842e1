"""VMC loop and CLI (port of ``deephall_tpu/train.py``).

Uniform walker init on the sphere or a restored checkpoint, the optimizer
state restored (and dropped if it belongs to another optimizer) or
initialised, burn-in and the initial-energy probe on a run that starts at step
0, then per iteration: MCMC sweep -> width adaptation -> optimizer step (KFAC,
Adam or inference) -> CSV row -> checkpoint, with the optimizer state, on
(time AND step multiple) OR NaN OR last step OR SIGTERM.  Iterations run one
per Python loop turn.

The sweep runs under ``no_grad`` with its feature tower in bfloat16 unless
``DEEPHALL_MCMC_DTYPE`` says ``f32`` (the JAX package's variable and default);
everything that feeds the local energy and the gradient runs in full float32,
with TF32 switched off at import.  Only the training step builds a graph.

    python -m deephall_tpu_torch.train key=value ... [--yml file] [--device cpu]
"""

from __future__ import annotations

import logging
import math
import os
import signal
import sys
import time
from argparse import ArgumentParser

import numpy as np
import torch
import yaml

from deephall_tpu_torch import mcmc, optimizers
from deephall_tpu_torch.config import (
    Config,
    OptimizerName,
    dotlist_to_dict,
    merge_dicts,
    resolve_interpolations,
    to_dict,
)
from deephall_tpu_torch.log import LogManager, init_logging
from deephall_tpu_torch.loss import LossMode, make_loss_fn
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.utils import resolve_device, set_full_precision
from deephall_tpu_torch.weights import init_params, load_flax, params_to_flax

set_full_precision()

logger = logging.getLogger("deephall")

def init_guess(generator: torch.Generator, batch: int, nelec: int, device) -> torch.Tensor:
    """Uniform samples on the sphere: ``[batch, nelec, 2]`` (theta, phi)."""
    u = torch.rand((batch, nelec), generator=generator, device=device)
    theta = torch.arccos(2 * u - 1)
    phi = (torch.rand((batch, nelec), generator=generator, device=device) * 2 - 1) * math.pi
    return torch.stack([theta, phi], dim=-1)


def sweep_dtype() -> torch.dtype | None:
    """The sweep tower's dtype from ``DEEPHALL_MCMC_DTYPE`` (default ``bf16``)."""
    if os.environ.get("DEEPHALL_MCMC_DTYPE", "bf16") in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None


def _host(v) -> float | complex:
    v = v.detach().cpu()
    return complex(v) if v.is_complex() else float(v)


def _write_row(writer, row: dict) -> None:
    """One ``train_stats.csv`` row, with the JAX package's fields and formats."""
    writer.log(
        step=str(row["step"]),
        pmove=f"{row['pmove']:.2f}",
        energy=f"{row['energy'].real:.4f}",
        energy_imag=f"{row['energy'].imag:+.4f}",
        potential=f"{row['potential']:.4f}",
        kinetic=f"{row['kinetic'].real:.4f}",
        variance=f"{row['variance']:.4f}",
        Lz=f"{row['angular_momentum_z']:+.4f}",
        Lz_square=f"{row['angular_momentum_z_square']:.4f}",
        L_square=f"{row['angular_momentum_square']:.4f}",
        step_time=f"{row['step_time']:.4f}",
    )


def train(cfg: Config, device: str | torch.device = "cuda") -> list[dict]:
    """Run the VMC loop; returns each iteration's statistics as host numbers."""
    device = resolve_device(device)
    init_logging()
    if cfg.system.orthogonal_states:
        raise NotImplementedError(
            "system.orthogonal_states is not ported yet: ROADMAP queue 1, item "
            "'Excited states and the rest of the loss'."
        )
    log_manager = LogManager(cfg)
    nelec = sum(cfg.system.nspins)
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    model = make_network(cfg.system, cfg.network)

    restored = log_manager.try_restore_checkpoint()
    adapt_restored: dict = {}
    if restored is not None:
        initial_step, state, adapt_restored = restored
        load_flax(model, state.params)
        opt_state = optimizers.validate_opt_state(cfg, state.opt_state)
        data = torch.as_tensor(state.data, dtype=torch.float32)
        mcmc_width = float(state.mcmc_width)
    else:
        initial_step = 0
        init_params(model, torch.Generator().manual_seed(cfg.seed))
        opt_state = None
        data = init_guess(generator, cfg.batch_size, nelec, device)
        mcmc_width = float(cfg.mcmc.width)
    model.to(device)
    if cfg.optim.optimizer == OptimizerName.none:
        model.requires_grad_(False)
    data = data.to(device)

    if (
        cfg.optim.optimizer == OptimizerName.none
        and cfg.log.restore_path is not None
        and cfg.log.restore_path != cfg.log.save_path
    ):  # Inference on a restored run is a fresh run: reset the step counter.
        initial_step = 0

    dtype = sweep_dtype()
    mcmc_step = mcmc.make_mcmc_step(lambda x: model(x, dtype), steps=cfg.mcmc.steps)
    opt_init, training_step = optimizers.make_optimizer_step(cfg, model)
    if opt_state is None:
        opt_state = opt_init(model, data)
    else:
        opt_state = optimizers.state_to(opt_state, device)
    logger.info("Start VMC on %s", torch.cuda.get_device_name(device) if device.type == "cuda" else device)

    with torch.no_grad():
        if initial_step == 0:
            for _ in range(cfg.mcmc.burn_in):
                data, _ = mcmc_step(data, mcmc_width, generator)
            logger.info("Burn in MCMC complete")
            if cfg.log.initial_energy:
                stats, _ = make_loss_fn(model, cfg.system, LossMode.ENERGY_DIFF)(data)
                logger.info("Initial energy: %s", _host(stats["energy"]).real)

    state = CheckpointState(None, data, opt_state, mcmc_width)
    pmoves = adapt_restored.get("pmoves")
    if pmoves is None or pmoves.shape != (cfg.mcmc.adapt_frequency,):
        pmoves = np.zeros(cfg.mcmc.adapt_frequency, dtype=np.float32)
    pmoves = np.array(pmoves, dtype=np.float32)
    t = int(adapt_restored.get("t", 0))

    history = []
    last_save_time = time.time()
    killer = GracefulKiller()
    try:
        with log_manager.create_writer() as writer:
            writer.hide("kinetic", "potential", "Lz_square", "step_time")
            step = initial_step
            while step < cfg.optim.iterations:
                start = time.perf_counter()
                with torch.no_grad():
                    data, pmove = mcmc_step(state.data, state.mcmc_width, generator)
                pmove = float(pmove)
                width = mcmc.update_mcmc_width(
                    t, state.mcmc_width, cfg.mcmc.adapt_frequency, pmove, pmoves
                )
                t += 1
                state, stats = training_step(state._replace(data=data, mcmc_width=width))
                row = {k: _host(v) for k, v in stats.items()}
                row.update(step=step, pmove=pmove, step_time=time.perf_counter() - start)
                history.append(row)
                _write_row(writer, row)
                step += 1
                energy_is_nan = math.isnan(row["energy"].real)
                current_time = time.time()
                if (
                    (
                        current_time - last_save_time > cfg.log.save_time_interval
                        and step % cfg.log.save_step_interval == 0
                    )
                    or energy_is_nan
                    or step >= cfg.optim.iterations
                    or killer.kill_now
                ):
                    last_save_time = current_time
                    writer.force_flush()
                    log_manager.save_checkpoint(
                        step - 1,
                        CheckpointState(
                            params_to_flax(model), state.data, state.opt_state, state.mcmc_width
                        ),
                        adapt={"pmoves": pmoves, "t": np.int32(t)},
                    )
                if killer.kill_now or energy_is_nan:
                    raise SystemExit("=" * 30 + " ABORT " + "=" * 30)
    finally:
        killer.restore()
    return history


class GracefulKiller:
    """Capture SIGINT/SIGTERM so a checkpoint is saved before exiting."""

    kill_now = False

    def __init__(self):
        self.original_int = signal.signal(signal.SIGINT, self.exit_gracefully)
        self.original_term = signal.signal(signal.SIGTERM, self.exit_gracefully)

    def exit_gracefully(self, signum, frame):
        """Latch the exit request; a second signal falls through to the original."""
        del signum, frame
        if self.kill_now:
            return
        print("\r", end="")  # Clear ^C
        self.restore()
        self.kill_now = True

    def restore(self):
        signal.signal(signal.SIGINT, self.original_int)
        signal.signal(signal.SIGTERM, self.original_term)


def cli(argv: list[str] | None = None) -> list[dict]:
    """``python -m deephall_tpu_torch.train key=value ... [--yml file] [--device cpu]``."""
    parser = ArgumentParser(
        prog="deephall-tpu-torch",
        description="Neural-network VMC for the fractional quantum Hall effect, "
        "on PyTorch and CUDA.",
    )
    parser.add_argument("dotlist", help="path.to.key=value pairs for configuration", nargs="*")
    parser.add_argument("--yml", help="config YML file to merge")
    parser.add_argument(
        "--device", default="cuda", help="torch device to run on (default: cuda)"
    )
    args = parser.parse_args(argv if argv is not None else (sys.argv[1:] or ["--help"]))

    config = to_dict(Config())
    if args.yml:
        with open(args.yml, encoding="utf8") as f:
            config = merge_dicts(config, yaml.safe_load(f) or {})
    config = merge_dicts(config, dotlist_to_dict(args.dotlist))
    config = resolve_interpolations(config)
    return train(Config.from_dict(config), device=args.device)


if __name__ == "__main__":
    cli()
