"""The system under test: ``deephall_tpu_torch`` set up for a cell, driven
through its iteration block, and its parts timed.

The cell's program is built as ``python -m deephall_tpu_torch.train`` builds
a run restored from a checkpoint (``train.run_generator``, the checkpoint
restored by ``log.LogManager``, ``train.load_fixed_states``,
``train.make_program``, ``train.penalty_operands``): the stored walkers and
parameters, the stored KFAC curvature, the stored width and acceptance ring.
No burn-in: the stored walkers are the run's equilibrated ones.  ``--seed``
seeds the run's generator, which makes every Metropolis draw.

Set-up drives the program through its first iterations as blocks of one
(:func:`record_steps`), keeping what the check needs, and then warms up one
block of the job's length.  The window (:func:`window`) then runs blocks of
that length, reading each block's statistics once (``train.host_rows``) as
``train.train`` does.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from benchmark.harness.cells import ROOT, Cell

FAULTS = ("unchanged", "half_batch", "altered", "sweep_unchanged")


def _merge(base: dict, extra: dict) -> dict:
    out = dict(base)
    for key, value in extra.items():
        out[key] = _merge(out[key], value) if isinstance(value, dict) and isinstance(out.get(key), dict) else value
    return out


def port_config(cell: Cell, seed: int, batch: int | None = None):
    """The port's ``Config`` of the cell: its configuration's sizes, then the job's settings."""
    from deephall_tpu_torch.config import Config, resolve_interpolations, to_dict

    sizes = {k: cell.config[k] for k in ("batch_size", "system", "network", "mcmc")}
    tree = _merge(_merge(to_dict(Config()), sizes), cell.job["config"])
    tree["seed"] = int(seed)
    if batch is not None:
        tree["batch_size"] = batch
    tree["system"]["orthogonal_states"] = [str(ROOT / p) for p in cell.job.get("fixed_states", [])]
    return Config.from_dict(resolve_interpolations(tree))


class Setup(NamedTuple):
    cfg: object
    model: torch.nn.Module
    generator: torch.Generator
    program: object  # train.Program
    fixed_states: list | None
    penalties: dict | None
    carry: list  # [state, pmoves, t]


def _faulty(cfg, program, generator, params: list, fault: str):
    """The program with one fault planted under its block: a step that returns
    its state unchanged, a step over half the walkers, the energy altered where
    the step produces it (as if one walker's local energy were doubled), or a
    sweep that returns its walkers unchanged."""
    from deephall_tpu_torch import train

    step, mcmc_step = program.training_step, program.mcmc_step

    def faulty_step(state, penalties=None):
        if fault == "unchanged":
            saved = [p.detach().clone() for p in params]
            _, stats = step(state, penalties)
            with torch.no_grad():
                for p, before in zip(params, saved):
                    p.copy_(before)
            return state, stats
        if fault == "half_batch":
            half = state.data.shape[0] // 2
            new, stats = step(state._replace(data=state.data[:half]), penalties)
            return new._replace(data=state.data), stats
        new, stats = step(state, penalties)
        if fault == "altered":
            stats = dict(stats)
            stats["energy"] = stats["energy"] * (1 + 1 / state.data.shape[0])
        return new, stats

    def faulty_sweep(data, width, gen):
        new, pmove = mcmc_step(data, width, gen)
        return (data, pmove) if fault == "sweep_unchanged" else (new, pmove)

    block = train.make_iteration_block(cfg, lambda x, width: faulty_sweep(x, width, generator),
                                       faulty_step)
    return program._replace(training_step=faulty_step, mcmc_step=faulty_sweep, block=block)


def build(cell: Cell, seed: int, device: torch.device, batch: int | None = None,
          fault: str | None = None) -> Setup:
    """The cell's program on ``device``, restored from the job's checkpoint;
    ``batch`` keeps the first walkers only (the CPU tests and the count);
    ``fault`` plants one of :data:`FAULTS`."""
    import numpy as np

    from deephall_tpu_torch import optimizers, train
    from deephall_tpu_torch.config import OptimizerName
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.types import CheckpointState
    from deephall_tpu_torch.weights import load_flax

    cfg = port_config(cell, seed, batch)
    generator = train.run_generator(cfg, device)
    model = make_network(cfg.system, cfg.network)
    _, stored, adapt = LogManager.restore_checkpoint(ROOT / cell.job["checkpoint"])
    load_flax(model, stored.params)
    opt_state = optimizers.validate_opt_state(cfg, stored.opt_state)
    data = torch.as_tensor(stored.data[:cfg.batch_size], dtype=torch.float32)
    model.to(device)
    if cfg.optim.optimizer == OptimizerName.none:
        model.requires_grad_(False)
    data = data.to(device)
    width = torch.tensor(float(stored.mcmc_width), dtype=torch.float32, device=device)
    fixed_states = train.load_fixed_states(cfg, device)
    program = train.make_program(cfg, model, generator, fixed_states)
    if fault is not None:
        program = _faulty(cfg, program, generator, list(model.parameters()), fault)
    opt_state = (program.opt_init(model, data) if opt_state is None
                 else optimizers.state_to(opt_state, device))
    pmoves = adapt.get("pmoves")
    if pmoves is None or pmoves.shape != (cfg.mcmc.adapt_frequency,):
        pmoves = np.zeros(cfg.mcmc.adapt_frequency, dtype=np.float32)
    pmoves = torch.tensor(np.asarray(pmoves, dtype=np.float32), device=device)
    t = torch.tensor(int(adapt.get("t", 0)), dtype=torch.int32, device=device)
    state = CheckpointState(None, data, opt_state, width)
    return Setup(cfg, model, generator, program, fixed_states, train.penalty_operands(cfg, device),
                 [state, pmoves, t])


def training(setup: Setup) -> bool:
    from deephall_tpu_torch.config import OptimizerName

    return setup.cfg.optim.optimizer != OptimizerName.none


class Step(NamedTuple):
    """One recorded iteration: the walkers and draws it started from, the
    walkers its sweep left (on which its statistics were taken), its host row
    and, in training, the parameters after it."""

    x_before: torch.Tensor
    generator_state: torch.Tensor
    width: torch.Tensor
    x_after: torch.Tensor
    row: dict
    params: dict | None


def _params(model) -> dict:
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def run_block(setup: Setup, length: int):
    """One call of the block, and its statistics read once: the host rows."""
    from deephall_tpu_torch import train

    state, pmoves, t = setup.carry
    with torch.profiler.record_function("block"):
        state, pmoves, t, stats, pmove = setup.program.block(state, pmoves, t, length, setup.penalties)
    with torch.profiler.record_function("host_rows"):
        rows = train.host_rows(stats, pmove)
    setup.carry[:] = [state, pmoves, t]
    return rows


def record_steps(setup: Setup, steps: int) -> tuple[dict, list[Step]]:
    """The parameters before, and the first ``steps`` iterations as blocks of one."""
    theta0 = _params(setup.model)
    records = []
    for _ in range(steps):
        state = setup.carry[0]
        before = (state.data.clone(), setup.generator.get_state(), state.mcmc_width.clone())
        row = run_block(setup, 1)[0]
        records.append(Step(*before, setup.carry[0].data.clone(), row,
                            _params(setup.model) if training(setup) else None))
    return theta0, records


class Window(NamedTuple):
    iterations: int
    seconds: float
    rows: list  # every iteration's host row
    blocks: list  # (walkers after the block, the block's last row)


def window(setup: Setup, seconds: float, device: torch.device) -> Window:
    """Blocks of the job's length until ``seconds`` have passed; the window
    closes at the end of the last block that completed inside them."""
    length = setup.cfg.optim.block_size
    rows, blocks = [], []
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    sync()
    start = last = time.perf_counter()
    while True:
        block_rows = run_block(setup, length)
        sync()
        now = time.perf_counter()
        if now - start > seconds:
            break
        last = now
        rows.extend(block_rows)
        blocks.append((setup.carry[0].data, block_rows[-1]))
    return Window(len(rows), last - start, rows, blocks)


def chain_ms(fn, device: torch.device, calls: int, warmup: int = 1) -> float:
    """ms a call over ``calls`` calls in a row after ``warmup``, by CUDA events
    (``scripts/torch_profile_step.py:chain_time``)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize(device)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def part_times(setup: Setup, device: torch.device, calls: int = 5) -> dict:
    """ms a call of the iteration's parts on the cell's current walkers: the
    sweep, the local energy and, in training, the forward with its two
    backward passes and the KFAC update (on copies of the parameters)."""
    from deephall_tpu_torch import loss
    from deephall_tpu_torch.optimizers import kfac

    cfg, model = setup.cfg, setup.model
    state = setup.carry[0]
    data, width = state.data, state.mcmc_width
    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    local_energy = loss.batched_local_energy(model, cfg.system)
    out = {}
    with torch.no_grad():
        out["sweep_ms"] = chain_ms(lambda: setup.program.mcmc_step(data, width, generator), device, calls)
        out["local_energy_ms"] = chain_ms(lambda: local_energy(data), device, calls)
        el, obs = local_energy(data)
    if training(setup):
        def capture():
            return loss.gradient_and_capture(model, cfg.system, data, el, obs,
                                             setup.fixed_states, setup.penalties)

        out["grad_ms"] = chain_ms(capture, device, calls)
        _, grads, inputs, dy = capture()
        specs = kfac.discover(model, sum(cfg.system.nspins))
        params = {k: p.detach().clone() for k, p in model.named_parameters()}
        out["kfac_update_ms"] = chain_ms(
            lambda: kfac.kfac_update(cfg.optim.kfac, specs, params, state.opt_state, grads, inputs, dy),
            device, calls)
    return out
