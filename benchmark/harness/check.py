"""What decides ``correct``: the program's recorded iterations held against the
plain reference (:mod:`benchmark.reference`), which follows them from the
stored checkpoint and the program's walkers.

The reference follows the program step by step: it takes the walkers that
the program's sweep left, and from them works out again, in float64, every
local energy and angular momentum by the full Hessian, the statistics with
their penalties and overlaps, and in training the clipped gradient and the
KFAC step on its own parameters and curvature.  The sweep it skips is
checked by itself: the reference replays the first recorded sweep from the
same generator state and walkers.

The numbers (each has a limit in ``benchmark/limits/<workload>.json``):

* ``stats_gap``: over every checked iteration and logged statistic (energy,
  variance, kinetic and potential energy, Lz, Lz^2, L^2 where computed, the
  overlap with the fixed states), ``|program - reference| / max(|reference|, 1)``;
  ``mean_gap`` the same without the variance, and ``variance_gap`` the
  variance's alone (the program takes it as a float32 difference of two
  means, which cancels: its gap is that rounding, far above the means');
* ``sweep_gap``: the share of walkers that the replayed sweep leaves more
  than 1e-3 (chord) from where the program's sweep left them;
* ``update_gap`` (training): by the worst leaf, the gap between the norms of
  the first step's parameter change, program against reference, over the
  reference's norm of that leaf or of the median leaf, whichever is larger;
* ``change_gap`` (training): the same of the change over all recorded steps.

Leaves whose gradient in the reference's first step is under a thousandth
of the median leaf's move by round-off alone and are left out of both.
"""

from __future__ import annotations

import math
import statistics
from contextlib import contextmanager
from typing import NamedTuple

import numpy as np
import torch

from benchmark.harness.cells import ROOT, Cell
from benchmark.reference import ckpt, energy, psiformer, sweep, vmc

STAT_KEYS = ("energy", "variance", "kinetic", "potential", "angular_momentum_z",
             "angular_momentum_z_square", "angular_momentum_square", "overlap")
CHORD = 1e-3
ROUND_OFF = 1e-3


class Chain(NamedTuple):
    """Iterations followed by one side: each one's statistics, and in training
    the parameters before the first and after each, and the first gradient."""

    stats: list  # [{key: number}]
    params: list | None  # [theta_0, theta_1, ...], {name: tensor}
    first_grads: dict | None


def spec_of(cell: Cell) -> psiformer.Spec:
    net = cell.config["network"]["psiformer"]
    return psiformer.Spec(tuple(cell.config["system"]["nspins"]), cell.config["system"]["flux"],
                          net["num_heads"], net["num_layers"])


def system_of(cell: Cell) -> dict:
    """The loss's settings: the job's over the configuration's (DeepHall's defaults under both)."""
    out = {"compute_l2": True, "dynamic_penalties": False, "l2_adaptive": False, "lz_penalty": 0.0,
           "lz_center": 0.0, "l2_penalty": 0.0, "l2_center": 0.0, "overlap_penalty": 1.0}
    for source in (cell.config["system"], cell.job["config"].get("system", {})):
        out.update({k: v for k, v in source.items() if k in out})
    return out


def kfac_of(cell: Cell) -> dict:
    k = cell.job["config"]["optim"]["kfac"]
    return {"rate": k["lr"]["rate"], "decay": k["lr"]["decay"], "delay": k["lr"]["delay"],
            "damping": k["damping"], "curvature_ema": k["curvature_ema"],
            "norm_constraint": k["norm_constraint"]}


def is_training(cell: Cell) -> bool:
    return cell.job["config"]["optim"]["optimizer"] != "none"


@contextmanager
def precision(tf32: bool):
    """TF32 in float32 products on (the control) or off."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _host(stats: dict) -> dict:
    return {k: complex(v) if torch.is_tensor(v) and v.is_complex() else float(v) for k, v in stats.items()}


def reference_chain(cell: Cell, walkers: list, device, dtype=torch.float64, tf32: bool = False,
                    rows: int = 560) -> Chain:
    """The reference over the walkers of each iteration, in ``dtype`` (float32
    with ``tf32`` for the control), from the stored run's file."""
    spec, system, flux = spec_of(cell), system_of(cell), cell.config["system"]["flux"]
    stored = ckpt.load(ROOT / cell.job["checkpoint"])

    def tensors(tree):
        if isinstance(tree, dict):
            return {k: tensors(v) for k, v in tree.items()}
        return torch.as_tensor(np.asarray(tree), device=device).to(dtype)

    params = tensors(stored.params)
    fixed = [tensors(ckpt.load(ROOT / p).params) for p in cell.job.get("fixed_states", [])]
    training = is_training(cell)
    curvature = tensors(stored.curvature._asdict()) if training else None
    chain = Chain([], [params] if training else None, None)
    first_grads = None
    with precision(tf32):
        for x in walkers:
            x = x.to(device=device, dtype=dtype)
            obs = energy.observables_in_blocks(lambda y: psiformer.logpsi(params, spec, y), x, flux, rows)
            log_ratios = None
            if fixed:
                with torch.no_grad():
                    log_ratios = torch.stack([psiformer.logpsi(f, spec, x) for f in fixed]) - obs["logpsi"][None]
            stats, diff = vmc.stats_and_diff(system, obs, log_ratios)
            if training:
                grads, inputs, dy = vmc.gradient_and_curvature(params, spec, x, vmc.weights(diff))
                params, curvature, info = vmc.kfac_step(params, curvature, grads, inputs, dy,
                                                        x.shape[0], kfac_of(cell))
                stats.update(info)
                chain.params.append(params)
                first_grads = first_grads or grads
            chain.stats.append(_host(stats))
    return chain._replace(first_grads=first_grads)


def program_chain(theta0: dict, records: list, window_rows: list = ()) -> Chain:
    """The program's side: its rows, and in training its parameters."""
    stats = [r.row for r in records] + list(window_rows)
    if records[0].params is None:
        return Chain(stats, None, None)
    return Chain(stats, [theta0] + [r.params for r in records], None)


def stats_gap(candidate: Chain, judge: Chain, report: dict | None = None) -> float:
    """The widest gap of a logged statistic; ``report`` gets each statistic's."""
    worst = {}
    for c, j in zip(candidate.stats, judge.stats, strict=True):
        for key in STAT_KEYS:
            if key not in j:
                continue
            gap = abs(c.get(key, math.nan) - j[key]) / max(abs(j[key]), 1.0)
            worst[key] = max(worst.get(key, 0.0), gap if math.isfinite(gap) else math.inf)
    if report is not None:
        report.update(worst)
    return max(worst.values())


def kept_leaves(judge: Chain) -> list[str]:
    """The leaves that the reference's first gradient moves: over a thousandth
    of the median leaf's gradient norm."""
    norms = {k: float(g.norm()) for k, g in judge.first_grads.items()}
    floor = ROUND_OFF * statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= floor]


def change_gap(candidate: Chain, judge: Chain, step: int, report: list | None = None) -> float:
    """By the worst kept leaf, the gap between the norms of the change over the
    first ``step`` steps; ``report`` gets the three worst leaves."""
    keep = kept_leaves(judge)
    ref = {k: float((judge.params[step][k] - judge.params[0][k]).norm()) for k in keep}
    got = {k: float((candidate.params[step][k].double().cpu() - candidate.params[0][k].double().cpu()).norm())
           for k in keep}
    median = statistics.median(ref.values())
    gaps = {k: abs(got[k] - ref[k]) / max(ref[k], median) for k in keep}
    gaps = {k: g if math.isfinite(g) else math.inf for k, g in gaps.items()}
    if report is not None:
        report.extend((k, gaps[k], ref[k], got[k], median) for k in sorted(gaps, key=gaps.get)[-3:])
    return max(gaps.values())


def sweep_gap(cell: Cell, first, device, steps: int) -> float:
    """The share of walkers that the replayed first sweep leaves elsewhere."""
    spec = spec_of(cell)
    params = {k: torch.as_tensor(v, device=device, dtype=torch.float64)
              for k, v in ckpt.load(ROOT / cell.job["checkpoint"]).params.items()}
    generator = torch.Generator(device=device)
    generator.set_state(first.generator_state)
    with torch.no_grad():
        x = sweep.sweep(lambda y: psiformer.logpsi(params, spec, y),
                        first.x_before.to(device=device, dtype=torch.float64),
                        first.width.to(device=device, dtype=torch.float64), generator, steps)

    def xyz(v):
        t, p = v[..., 0], v[..., 1]
        return torch.stack([torch.sin(t) * torch.cos(p), torch.sin(t) * torch.sin(p), torch.cos(t)], -1)

    apart = (xyz(x) - xyz(first.x_after.to(device=device, dtype=torch.float64))).norm(dim=-1)
    return float((apart.amax(dim=-1) > CHORD).double().mean())


def numbers(cell: Cell, candidate: Chain, judge: Chain, report: dict | None = None) -> dict:
    """Every number of the cell but the sweep's, of ``candidate`` against
    ``judge``; ``report`` gets the worst leaves of the training numbers."""
    report = {} if report is None else report
    keys = report.setdefault("stats_keys", {})
    out = {"stats_gap": stats_gap(candidate, judge, keys)}
    out["mean_gap"] = max(v for k, v in keys.items() if k != "variance")
    out["variance_gap"] = keys["variance"]
    if candidate.params is not None:
        out["update_gap"] = change_gap(candidate, judge, 1, report.setdefault("update_leaves", []))
        out["change_gap"] = change_gap(candidate, judge, len(judge.params) - 1,
                                       report.setdefault("change_leaves", []))
    return out


def judged(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {value, limit}})``: every number that the cell's
    limits name at or under its limit."""
    table = {k: {"value": values[k], "limit": limit} for k, limit in limits.items()}
    return all(math.isfinite(r["value"]) and r["value"] <= r["limit"] for r in table.values()), table
