"""VMC loop and CLI (port of ``deephall_tpu/train.py``).

Uniform walker init on the sphere or a restored checkpoint, the optimizer
state restored (and dropped if it belongs to another optimizer) or
initialised, the fixed lower states of an excited-state run loaded, burn-in
and the initial-energy probe on a run that starts at step 0, then blocks of
``optim.block_size`` iterations: per iteration MCMC sweep -> width adaptation
-> optimizer step (KFAC, Adam or inference), all on the device; per block one
read of the block's statistics to the host -> CSV rows -> checkpoint, with the
optimizer state, on (time AND step multiple) OR NaN OR last step OR SIGTERM.
``log.profile_dir`` records a ``torch.profiler`` trace of the blocks that
cover ``[profile_start, profile_start + profile_steps)``, the port's layers in
it as ``deephall.*`` ranges.  ``tracing.blocks()`` returns the device-clock
time of those layers in each of the last 512 blocks.

Launched by ``torchrun`` (or Slurm, or OpenMPI) on K processes, each rank
holds ``batch_size / K`` walkers on its own device and the statistics, the
gradient and the curvature are those of the whole batch
(:mod:`deephall_tpu_torch.parallel`); rank 0 alone writes the CSV, the
``config.yml`` sidecar, the checkpoints and the trace.  Every rank takes the
same save decision from the block's one host read: it saves when any rank's
clock or signal asks.  A single process reads its own clock and signal after
that read, as before.

The sweep runs under ``no_grad`` with its feature tower in bfloat16 unless
``DEEPHALL_MCMC_DTYPE`` says ``f32`` (the JAX package's variable and default);
everything that feeds the local energy and the gradient runs in full float32,
with TF32 switched off at import.  Only the training step builds a graph.

    python -m deephall_tpu_torch.train key=value ... [--yml file] [--device cpu]
    torchrun --nproc_per_node=K -m deephall_tpu_torch.train key=value ... [--backend gloo]
"""

from __future__ import annotations

import datetime
import logging
import math
import os
import signal
import sys
import time
from argparse import ArgumentParser
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch
import yaml

from deephall_tpu_torch import mcmc, optimizers, parallel, tracing
from deephall_tpu_torch.config import (
    Config,
    OptimizerName,
    dotlist_to_dict,
    merge_dicts,
    resolve_interpolations,
    to_dict,
)
from deephall_tpu_torch.log import LogManager, init_logging
from deephall_tpu_torch.loss import PENALTY_KEYS, LossMode, make_loss_fn
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.observables import runner
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.utils import set_full_precision
from deephall_tpu_torch.weights import init_params, load_flax, params_to_flax

set_full_precision()

logger = logging.getLogger("deephall")


def init_guess(generator: torch.Generator, batch: int, nelec: int, device) -> torch.Tensor:
    """Uniform samples on the sphere: ``[batch, nelec, 2]`` (theta, phi) for the
    global ``batch``, of which this rank keeps its rows."""
    draws = dict(generator=generator, device=device)
    shape = (batch // parallel.world_size(), nelec)
    u = parallel.draw_rows(torch.rand, shape, **draws)
    theta = torch.arccos(2 * u - 1)
    phi = (parallel.draw_rows(torch.rand, shape, **draws) * 2 - 1) * math.pi
    return torch.stack([theta, phi], dim=-1)


def sweep_dtype() -> torch.dtype | None:
    """The sweep tower's dtype from ``DEEPHALL_MCMC_DTYPE`` (default ``bf16``)."""
    if os.environ.get("DEEPHALL_MCMC_DTYPE", "bf16") in ("bf16", "bfloat16"):
        return torch.bfloat16
    return None


def load_fixed_states(cfg: Config, device) -> list | None:
    """``system.orthogonal_states`` as callables ``data -> log phi_j`` on ``device``.

    Each checkpoint (with its ``config.yml`` sidecar) is a converged lower
    state of an excited-state run: a float32 module with frozen parameters
    (the Psiformer) or none (the Laughlin / CF state), evaluated without
    gradients.

    Raises:
        ValueError: if a fixed state was trained on another system (flux,
            electron count, radius).
    """
    if not cfg.system.orthogonal_states:
        return None
    fixed = []
    for path in cfg.system.orthogonal_states:
        fcfg = runner.load_config(path)
        same_system = (
            fcfg.system.flux == cfg.system.flux
            and tuple(fcfg.system.nspins) == tuple(cfg.system.nspins)
            and fcfg.system.radius == cfg.system.radius
        )
        if not same_system:
            raise ValueError(
                f"orthogonal state {path} was trained on a different system "
                f"(flux={fcfg.system.flux}, nspins={fcfg.system.nspins}, "
                f"radius={fcfg.system.radius})"
            )
        _, model, _, _, _ = runner.load_run(path)
        fixed.append(_frozen(model.to(device).requires_grad_(False)))
        logger.info("Orthogonality penalty against %s", path)
    return fixed


def _frozen(model):
    def log_phi(data: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return model(data)

    return log_phi


def penalty_operands(cfg: Config, device) -> dict | None:
    """The dynamic-penalty operands (``system.dynamic_penalties``): 0-d float32
    tensors on ``device``, made once per run."""
    if not cfg.system.dynamic_penalties:
        return None
    return {k: torch.tensor(float(getattr(cfg.system, k)), device=device) for k in PENALTY_KEYS}


def make_iteration_block(cfg: Config, mcmc_step, training_step):
    """``length`` iterations at a time on the device (``deephall_tpu/train.py:
    make_iteration_block``).

    Args:
        cfg: the run's configuration (``mcmc.adapt_frequency``).
        mcmc_step: ``(data, width) -> (data, pmove)``, drawing from the run's
            generator, so that the draws do not depend on how iterations are
            grouped into blocks.
        training_step: ``(state, penalties) -> (state, stats)``.

    Returns:
        ``block(state, pmoves, t, length, penalties=None) -> (state, pmoves, t,
        stats, pmove)``: ``state.mcmc_width``, the acceptance ring ``pmoves``
        and the iteration counter ``t`` are device tensors; ``stats`` is
        ``{key: [length] tensor}`` and ``pmove`` ``[length]``, stacked on the
        device.  Nothing in a block reads a value back to the host.  Each
        call is one block record of :mod:`deephall_tpu_torch.tracing`, its
        sweeps in the span ``sweep``.
    """
    adapt = cfg.mcmc.adapt_frequency

    def block(state, pmoves, t, length: int, penalties=None):
        rows, pmove_rows = [], []
        with tracing.block(length, state.data.device):
            for _ in range(length):
                with torch.no_grad(), tracing.span("sweep"):
                    data, pmove = mcmc_step(state.data, state.mcmc_width)
                width, pmoves = mcmc.adapt_width(t, state.mcmc_width, pmoves, pmove, adapt)
                t = t + 1
                state, stats = training_step(state._replace(data=data, mcmc_width=width), penalties)
                rows.append(stats)
                pmove_rows.append(pmove)
        device = state.data.device
        stats = {k: torch.stack([torch.as_tensor(row[k], device=device) for row in rows])
                 for k in rows[0]}
        return state, pmoves, t, stats, torch.stack(pmove_rows)

    return block


class Program(NamedTuple):
    """What a run executes on its walkers, as :func:`train` builds it."""

    mcmc_step: Callable  # (data, width, generator) -> (data, pmove)
    opt_init: Callable  # (model, data) -> a fresh optimizer state
    training_step: Callable  # (state, penalties=None) -> (state, stats)
    block: Callable  # make_iteration_block over both, drawing from the run's generator


def run_generator(cfg: Config, device) -> torch.Generator:
    """The run's one generator, seeded from ``cfg.seed``: the walkers, then every sweep."""
    generator = torch.Generator(device=device)
    generator.manual_seed(cfg.seed)
    return generator


def fresh_walkers(cfg: Config, model, generator: torch.Generator, device) -> torch.Tensor:
    """A fresh run's start: ``model``'s parameters from ``cfg.seed`` (in place)
    and the walkers drawn from ``generator``."""
    init_params(model, torch.Generator().manual_seed(cfg.seed))
    return init_guess(generator, cfg.batch_size, sum(cfg.system.nspins), device)


def make_program(cfg: Config, model, generator: torch.Generator, fixed_states=None) -> Program:
    """The sweep (its tower in :func:`sweep_dtype`, replayed as CUDA graphs on a
    card: ``mcmc.GraphedSweep``), the optimizer's init and training step, and
    the iteration block over both, drawing from ``generator``."""
    dtype = sweep_dtype()
    mcmc_step = mcmc.make_mcmc_step(lambda x: model(x, dtype), steps=cfg.mcmc.steps, graphed=True)
    opt_init, training_step = optimizers.make_optimizer_step(cfg, model, fixed_states)
    block = make_iteration_block(
        cfg, lambda x, width: mcmc_step(x, width, generator), training_step)
    return Program(mcmc_step, opt_init, training_step, block)


def host_rows(stats: dict, pmove: torch.Tensor) -> list[dict]:
    """A block's statistics as one row of host numbers per iteration, read in one copy."""
    columns, layout = [], []
    for key, v in stats.items():
        parts = (v.real, v.imag) if v.is_complex() else (v,)
        layout.append((key, len(parts)))
        columns.extend(p.to(torch.float64) for p in parts)
    table = torch.stack([*columns, pmove.to(torch.float64)]).cpu().numpy()
    rows = []
    for i in range(table.shape[1]):
        row, j = {}, 0
        for key, n in layout:
            row[key] = complex(table[j, i], table[j + 1, i]) if n == 2 else float(table[j, i])
            j += n
        row["pmove"] = float(table[j, i])
        rows.append(row)
    return rows


def save_flags(stop: bool, save_due: bool, device) -> torch.Tensor:
    """``[stop, save_due]`` as a device tensor, each the largest over the ranks:
    read with the block's statistics, so that every rank takes the same save
    decision."""
    return parallel.all_reduce_max(
        torch.stack([torch.full((), float(v), device=device) for v in (stop, save_due)]))


def _write_row(writer, row: dict) -> None:
    """One ``train_stats.csv`` row, with the JAX package's fields and formats."""
    extra = {"overlap": f"{row['overlap']:.4f}"} if "overlap" in row else {}
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
        **extra,
    )


class Profile:
    """``torch.profiler`` over a window of iterations, written as a Chrome trace."""

    def __init__(self, cfg: Config, device: torch.device):
        self.cfg, self.device = cfg.log, device
        self.profiler = None
        self.done = cfg.log.profile_dir is None or parallel.rank() != 0

    def before_block(self, rel: int, length: int) -> None:
        """Start before the block that reaches ``profile_start``; stop at the
        first block that begins past the window (``rel`` counts from the run's
        first step)."""
        if self.done:
            return
        if self.profiler is None and rel + length > self.cfg.profile_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=activities)
            self.profiler.start()
        elif self.profiler is not None and rel >= self.cfg.profile_start + self.cfg.profile_steps:
            self.stop()

    def stop(self) -> None:
        if self.profiler is None:
            return
        self.profiler.stop()
        path = Path(self.cfg.profile_dir)
        path.mkdir(parents=True, exist_ok=True)
        self.profiler.export_chrome_trace(str(path / "trace.json"))
        logger.info("Saved profiler trace to %s", path / "trace.json")
        self.profiler, self.done = None, True


def run_start(cfg: Config, device) -> datetime.datetime | None:
    """Rank 0's clock, on every rank, for a run without ``log.save_path`` (its
    directory's name); ``None`` for a run with one."""
    if cfg.log.save_path is not None:
        return None
    stamp = torch.full((1,), time.time(), dtype=torch.float64, device=device)
    parallel.broadcast_(stamp)
    return datetime.datetime.fromtimestamp(stamp.item())


def train(cfg: Config, device: str | torch.device = "cuda", backend: str | None = None) -> list[dict]:
    """Run the VMC loop; returns each iteration's statistics as host numbers.

    Joins the launch's process group first (``parallel.initialize_distributed``:
    ``device`` ``cuda`` is this rank's card, ``backend`` NCCL or gloo).
    """
    init_logging()
    device = parallel.initialize_distributed(device, backend)
    ranks = parallel.world_size()
    if cfg.batch_size % ranks:
        raise ValueError(f"batch_size={cfg.batch_size} must be divisible by {ranks} ranks")
    log_manager = LogManager(cfg, write_artifacts=parallel.rank() == 0,
                             now=run_start(cfg, device))
    generator = run_generator(cfg, device)
    model = make_network(cfg.system, cfg.network)

    restored = log_manager.try_restore_checkpoint()
    adapt_restored: dict = {}
    if restored is not None:
        initial_step, state, adapt_restored = restored
        load_flax(model, state.params)
        opt_state = optimizers.validate_opt_state(cfg, state.opt_state)
        data = parallel.shard_rows(torch.as_tensor(state.data, dtype=torch.float32))
        mcmc_width = float(state.mcmc_width)
    else:
        initial_step = 0
        opt_state = None
        data = fresh_walkers(cfg, model, generator, device)
        mcmc_width = float(cfg.mcmc.width)
    model.to(device)
    params = list(model.parameters())
    if params:  # every rank starts from rank 0's parameters
        parallel.broadcast_(*params)
    if cfg.optim.optimizer == OptimizerName.none:
        model.requires_grad_(False)
    data = data.to(device)
    mcmc_width = torch.tensor(mcmc_width, dtype=torch.float32, device=device)

    if (
        cfg.optim.optimizer == OptimizerName.none
        and cfg.log.restore_path is not None
        and cfg.log.restore_path != cfg.log.save_path
    ):  # Inference on a restored run is a fresh run: reset the step counter.
        initial_step = 0

    fixed_states = load_fixed_states(cfg, device)
    program = make_program(cfg, model, generator, fixed_states)
    if opt_state is None:
        opt_state = program.opt_init(model, data)
    else:
        opt_state = optimizers.state_to(opt_state, device)
    logger.info("Start VMC on %s, rank %d of %d",
                torch.cuda.get_device_name(device) if device.type == "cuda" else device,
                parallel.rank(), ranks)

    with torch.no_grad():
        if initial_step == 0:
            for _ in range(cfg.mcmc.burn_in):
                data, _ = program.mcmc_step(data, mcmc_width, generator)
            logger.info("Burn in MCMC complete")
            if cfg.log.initial_energy:
                probe = make_loss_fn(model, cfg.system, LossMode.ENERGY_DIFF, fixed_states)
                stats, _ = probe(data)
                logger.info("Initial energy: %s", stats["energy"].real.item())

    penalties = penalty_operands(cfg, device)
    state = CheckpointState(None, data, opt_state, mcmc_width)
    # The width ring and its counter survive a save/restore boundary.
    pmoves = adapt_restored.get("pmoves")
    if pmoves is None or pmoves.shape != (cfg.mcmc.adapt_frequency,):
        pmoves = np.zeros(cfg.mcmc.adapt_frequency, dtype=np.float32)
    pmoves = torch.tensor(np.asarray(pmoves, dtype=np.float32), device=device)
    t = torch.tensor(int(adapt_restored.get("t", 0)), dtype=torch.int32, device=device)
    block_size = max(1, cfg.optim.block_size)
    profile = Profile(cfg, device)

    history = []
    # Under a process group the save gathers the walkers, a collective: every
    # rank then takes the decision from the flags of all, read with the block.
    grouped = parallel.in_group()
    last_save_time = time.time()
    killer = GracefulKiller()
    try:
        with log_manager.create_writer() as writer:
            writer.hide("kinetic", "potential", "Lz_square", "step_time")
            step = initial_step
            while step < cfg.optim.iterations:
                length = min(block_size, cfg.optim.iterations - step)
                profile.before_block(step - initial_step, length)
                start = time.perf_counter()
                state, pmoves, t, stats, pmove = program.block(state, pmoves, t, length, penalties)
                flags = {}
                if grouped:
                    both = save_flags(
                        killer.kill_now,
                        time.time() - last_save_time > cfg.log.save_time_interval, device)
                    flags = {"stop": both[0].expand(length), "save_due": both[1].expand(length)}
                rows = host_rows({**stats, **flags}, pmove)
                step_time = (time.perf_counter() - start) / length
                if grouped:
                    stop, save_due = (rows[0][key] > 0 for key in flags)
                for i, row in enumerate(rows):
                    for key in flags:
                        del row[key]
                    row.update(step=step + i, step_time=step_time)
                    _write_row(writer, row)
                history.extend(rows)
                step += length
                energy_is_nan = any(math.isnan(row["energy"].real) for row in rows)
                current_time = time.time()
                if not grouped:
                    stop = killer.kill_now
                    save_due = current_time - last_save_time > cfg.log.save_time_interval
                if (
                    (save_due and step % cfg.log.save_step_interval == 0)
                    or energy_is_nan
                    or step >= cfg.optim.iterations
                    or stop
                ):
                    last_save_time = current_time
                    writer.force_flush()
                    log_manager.save_checkpoint(
                        step - 1,
                        CheckpointState(params_to_flax(model), state.data, state.opt_state,
                                        state.mcmc_width.item()),
                        adapt={"pmoves": pmoves.cpu().numpy(), "t": np.int32(t.item())},
                    )
                if stop or energy_is_nan:
                    raise SystemExit("=" * 30 + " ABORT " + "=" * 30)
    finally:
        profile.stop()
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
    """``python -m deephall_tpu_torch.train key=value ... [--yml file] [--device cpu]``;
    under ``torchrun --nproc_per_node=K`` the walkers split over K ranks."""
    parser = ArgumentParser(
        prog="deephall-tpu-torch",
        description="Neural-network VMC for the fractional quantum Hall effect, "
        "on PyTorch and CUDA.  Several GPUs: torchrun --nproc_per_node=K -m "
        "deephall_tpu_torch.train ... splits batch_size over K ranks, one card each.",
    )
    parser.add_argument("dotlist", help="path.to.key=value pairs for configuration", nargs="*")
    parser.add_argument("--yml", help="config YML file to merge")
    parser.add_argument(
        "--device", default="cuda",
        help="torch device to run on (default: cuda, which is cuda:LOCAL_RANK under torchrun; "
        "cuda:0 puts every rank on card 0, with --backend gloo)",
    )
    parser.add_argument(
        "--backend", choices=parallel.BACKENDS, default=None,
        help="torch.distributed backend under torchrun (default: nccl on CUDA, gloo on the "
        "CPU); gloo runs several ranks on one card, which nccl refuses",
    )
    args = parser.parse_args(argv if argv is not None else (sys.argv[1:] or ["--help"]))

    config = to_dict(Config())
    if args.yml:
        with open(args.yml, encoding="utf8") as f:
            config = merge_dicts(config, yaml.safe_load(f) or {})
    config = merge_dicts(config, dotlist_to_dict(args.dotlist))
    config = resolve_interpolations(config)
    return train(Config.from_dict(config), device=args.device, backend=args.backend)


if __name__ == "__main__":
    cli()
