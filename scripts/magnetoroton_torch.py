"""Magnetoroton dispersion driver of the PyTorch port: per-Lz-sector excited-state VMC.

The port's copy of ``scripts/magnetoroton.py``: the same planning functions
(copied, not imported), the same command line, the same ``{out}/sector_{m}/``
layout, ``dispersion.csv`` columns and resume, NaN-retry and skip-done
behaviour, on ``deephall_tpu_torch.train.train(cfg, device)`` and the port's
copy of the exact-diagonalization oracle (``deephall_tpu_torch.observables.ed``).
It runs on ``--device cuda`` unless ``--device cpu`` is given, and raises
without a card; a sector run of the Psiformer goes through the hand-written
jet kernels.

Method: on the sphere, ``L^2`` and ``Lz`` commute with ``H``, and each
L-multiplet contributes exactly one member per ``|Lz| <= L``.  A sector run
minimizes the *linear* objective ``E + k_z <(Lz - m)^2> + k <L^2>``; linear
combinations of commuting observables are extremal on eigenstates (vertices of
the convex hull of ``(E, Lz, L^2)`` points), so the optimum is a pure
eigenstate and the separately-measured energy is unbiased.  The ``L = m``
magnetoroton member is the minimum-``L^2`` state of the ``Lz = m`` sector, so
any ``k`` in the window ``gap / L^2-spacing < k < k_z / 2 m_max`` selects it —
below the lower edge the sector minimum wins, above the upper edge the state
tunnels into a lower-L *sector* (the L^2 saving beats the Lz mismatch) — and
the L=0 ground state is excluded automatically (its Lz penalty costs
``k_z m^2``).  The default ``--selector onesided`` floors the penalty at the
target multiplet instead (``system.l2_center = m(m+1)``, gradient
``k * relu(<L^2> - c)``): in-sector it is the same unbiased linear selector
(every ``Lz = m`` state has ``L >= m``), it is exactly zero at the converged
target (no residual bias to trade against), and it can stay on during the
escape stage to suppress the high-L overshoot.  The floor does NOT remove
the tunneling channel, though — measured in the N=6 sweep (sector 2 rescue,
k = 2.0): while ``<L^2>`` sits above the floor, trading above-floor
contamination into *below*-floor components (L=1, Lz=1) still lowers the
penalty at a fixed Lz cost, and the state drifted Lz 2 -> 1.31.  The same
stability window therefore binds in both modes; the driver keeps the
requested ``k`` inside it by raising the purify-stage Lz penalty to
``3 k m`` (unbiased: the Lz penalty is exactly zero at the in-sector
target) instead of clamping ``k`` down (measured 30x slower rotation at the
window-clamped k).  Stiff stages only *transit*, though — they dominate the
KFAC geometry and the energy does not converge under them (measured: rows
taken in the stiff stage sat 0.4-0.8 above the exact sector energies with
variance ~1), so every sector ends in a gentle ``settle`` stage
(``settle_k``: window-clamped selector at the nominal Lz penalty) that the
dispersion row is measured on.  Measured on CPU at
N=4 (BASELINE.md): without the ``L^2`` term a sector run may land on a
*different branch member* (Lz=3 found the L=4 state) or a slowly-converging
mixture; with it, each sector converges to its ``L = m`` state.  ``--chain``
adds overlap-penalty states above the first (higher bands), where the
``L^2`` selector is disabled.

Usage (one sector at a time on the card):

    python scripts/magnetoroton_torch.py --config artifacts/prod_r4/config.yml \
        --restore artifacts/prod_r4/ckpt_019999.npz --out runs/roton \
        --sectors 2 3 4 5 6 --iterations 20000 [--device cpu]

Each sector writes ``{out}/sector_{m}/`` (checkpoints + train_stats.csv) and
the script appends tail energies to ``{out}/dispersion.csv``.  Gaps are
``E_m - E_ground``; take ``E_ground`` from the converged ground run's stats.

The port's excited states are validated against the ED oracle in
``tests/test_torch_excited.py::test_excited_state_end_to_end``.
"""

from __future__ import annotations

import argparse
import csv
import sys
from pathlib import Path

import numpy as np
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class PhaseDiverged(RuntimeError):
    """A phase that still ends in a NaN abort after its retries."""


def all_finite(tree) -> bool:
    """Whether every array of a checkpoint's nested ``params`` dict is finite."""
    if isinstance(tree, dict):
        return all(all_finite(v) for v in tree.values())
    return bool(np.isfinite(np.asarray(tree)).all())


def escape_kick(lz_penalty: float, m: int) -> float:
    """Escape-stage Lz penalty: a strong kick, capped for stability.

    The warm start sits at the Lz=0 ground state, so the escape stage starts
    with penalty magnitude ``kick * m^2``; the kick must be strong enough to
    amplify the tiny symmetry-breaking admixture within the stage, but the
    N=6 sweep measured the 4x kick blowing the parameters up to NaN at m=4
    (``kick * m^2 = 64``) ~1750 steps into the escape, while m=3 (36) ran
    stably.  Cap the ground-state penalty magnitude at that largest
    measured-stable value; the NaN-retry in the driver halves further if a
    specific run still diverges.
    """
    return lz_penalty * min(4.0, 36.0 / max(1, m) ** 2)


def stable_lz(k: float, m: int, lz_nominal: float) -> float:
    """Lz penalty keeping the L^2 selector inside the tunneling window.

    Tunneling from the (L=m, Lz=m) target toward lower-Lz components costs
    ``lz`` of Lz penalty per unit weight but saves ``~2mk`` of L^2 penalty,
    so stability needs ``k < 0.8 * lz / (2m)`` (measured at N=4; re-measured
    at N=6 where k=2.0 at the nominal lz=1 tunneled even with the one-sided
    floor).  Raising lz instead of clamping k keeps the measured ~30x faster
    rotation of large k: the Lz penalty is exactly zero at the in-sector
    target, so a stiff value is unbiased there (and, unlike the escape kick,
    it acts on a state already sitting at Lz ~ m, so its gradient is small).
    """
    if not k or m <= 0:
        return lz_nominal
    return max(lz_nominal, 3.0 * k * m)


def settle_k_from_ed(
    energies_total: list[float], l2s: list[float], target_index: int,
    m: int, lz_nominal: float,
) -> float:
    """ED-informed settle-stage selector strength for the ``L = m`` member.

    The round-4 sweep measured both horns of a *blind* settle stiffness: a
    window-clamped constant k = 0.2 could not hold sector 2 against the energy
    drift toward the lower-lying L=4 roton member (L^2 crept 7.8 -> 8.1), and
    the adaptive selector never left its stiff regime (equilibrium impurity
    scales as 1/k_eff, so ``k_eff = k * impurity`` settles at ``sqrt(c k)`` —
    sector 4 plateaued at L^2 = 20.24 under lz_eff ~ 6 with the energy stuck
    0.22 high at variance 0.29).  The exact spectrum removes the blindness:
    the ED block (already computed for the row's anchor) lists every state
    *below* the target in its Lz = m block, and the one-sided floor penalty
    ``k relu(L^2 - m(m+1))`` beats contaminant ``i`` exactly when

        k > (E_target - E_i) / (L^2_i - m(m+1)).

    Sectors whose target IS the block ground state (N=6: Lz=4 — the roton
    minimum — and Lz=6) need no selector at all: plain Lz-pinned energy
    minimization converges onto the member, so the settle uses a tiny guard
    k = 0.02 that only suppresses noise excursions (one-sided: exactly zero
    at and below the target, hence unbiased).  Hard sectors get 10x the
    ED-margin requirement, clamped to half the tunneling window
    ``0.8 lz / (2m)`` — for N=6 sector 2 that is k ~= 0.055, nearly 4x
    gentler than the round-4 "gentle" leg that still failed to converge.
    """
    guard = 0.02
    window = 0.8 * lz_nominal / (2.0 * max(1, m))
    need = 0.0
    target = m * (m + 1)
    for energy, l2 in zip(
        energies_total[:target_index], l2s[:target_index]
    ):
        margin_l2 = l2 - target
        if margin_l2 > 0.5:  # below-target energy, above-target L^2
            need = max(
                need, (energies_total[target_index] - energy) / margin_l2
            )
    return float(min(max(guard, 10.0 * need), 0.5 * window))


def settle_k(l2_penalty: float, m: int, lz_nominal: float) -> float:
    """Settle-stage selector strength: window-clamped at the *nominal* lz.

    Stiff penalties rotate the state into the sector fast, but they dominate
    the KFAC geometry and the energy never converges — measured in the N=6
    sweep, where the stiff purify stages (k up to 2.25, lz = 3km up to 13.5)
    left sector 2 at E = 7.780(2) with variance 1.1 and sector 3 at
    E = 7.407(2) with variance 0.74, versus their exact targets 7.0033 /
    6.9706 (the earlier *gentle* pass had E = 7.134 / 7.030 with variance
    0.3 / 0.13: stiffness made purity slightly better and the energy far
    worse).  The dispersion row must therefore come from a final settle
    stage at the nominal Lz penalty, with the selector clamped inside the
    tunneling window ``k < 0.8 * lz / (2m)`` — a gentle linear objective is
    still extremal on the target eigenstate (unbiased), it merely rotates
    slowly, which the settle stage does not need to do.
    """
    if not l2_penalty or m <= 0:
        return l2_penalty
    return min(l2_penalty, 0.8 * lz_nominal / (2.0 * m))


def plan_phases(
    level: int, l2_penalty: float, lz_penalty: float,
    base_step: int, iterations: int, one_sided: bool = False, m: int = 0,
    adaptive: bool = False, settle_k_value: float | None = None,
) -> list[tuple[float, float, int, str]]:
    """Stage plan ``[(l2_penalty, lz_penalty, iteration_target, kind), ...]``.

    Three stages for the one-sided L^2-selected first state (each measured
    necessary in the N=4/N=6 sweeps):

    * ``escape`` — a symmetry eigenstate is a stationary point of every
      penalty's covariance gradient (the local values are constant), so the
      warm-started run leaves the Lz=0 ground state only via a deliberately
      strong Lz kick (capped, see ``escape_kick``); the one-sided selector
      rides along gated off at the ground (zero below the floor) to suppress
      the measured high-L overshoot, clamped to the kick's own stability
      window.
    * ``purify`` — the L^2 selector at full strength rotates the state onto
      the targeted L = m member, with the Lz penalty raised to keep the
      selector inside the tunneling stability window (see ``stable_lz``).
      Stiff penalties rotate ~30x faster than window-clamped ones, but they
      dominate the KFAC geometry: the energy does NOT converge here.
    * ``settle`` — the dispersion point is measured under the *nominal* Lz
      penalty with the selector clamped into the tunneling window
      (``settle_k``): unbiased at the target eigenstate (every penalty term
      vanishes there exactly) and gentle enough for the energy to converge.
      Measured in the N=6 sweep: rows taken from the stiff purify stage were
      0.4-0.8 too high with variance ~1 (see ``settle_k``).

    The legacy two-sided window selector keeps its original two-stage plan
    (escape, then a window-clamped purify): its purify stage is already
    gentle, so it doubles as the settle stage.
    """
    gentle = (
        settle_k_value if settle_k_value is not None
        else settle_k(l2_penalty, m, lz_penalty)
    )
    if level == 0 and l2_penalty:
        kick = escape_kick(lz_penalty, m)
        k_escape = min(l2_penalty, 0.8 * kick / (2.0 * max(1, m)))
        if adaptive:
            # Three stages: the in-graph deviation-proportional stiffness
            # (config.System.l2_adaptive) handles escape and purify — stiff
            # while far from the target multiplet, annealing toward it, with
            # the Lz penalty raised in-graph to track the tunneling window
            # (the escape leg clamps the selector to the kick's own stability
            # window so the in-graph Lz raise 3 m k_eff cannot exceed ~1.2x
            # the capped kick mid-escape; kick * m^2 = 64 measured NaN at
            # m=4).  The dispersion row is then measured on a FIXED gentle
            # settle leg: round 4 measured that the adaptive leg never
            # reaches the gentle regime — its equilibrium impurity scales as
            # 1/k_eff, so k_eff plateaus at sqrt(c k) (sector 4 stuck at
            # L^2 = 20.24 under lz_eff ~ 6, E 0.22 high, variance 0.29) and
            # the stiff geometry blocks energy convergence.
            return [
                (k_escape, kick,
                 base_step + max(1, int(0.3 * iterations)), "escape"),
                (l2_penalty, lz_penalty,
                 base_step + max(2, int(0.6 * iterations)), "purify"),
                (gentle, lz_penalty, base_step + iterations, "settle"),
            ]
        if not one_sided:
            return [
                (0.0, kick, base_step + iterations // 2, "escape"),
                (l2_penalty, lz_penalty, base_step + iterations, "settle"),
            ]
        return [
            (k_escape, kick,
             base_step + max(1, int(0.3 * iterations)), "escape"),
            (l2_penalty, stable_lz(l2_penalty, m, lz_penalty),
             base_step + max(2, int(0.6 * iterations)), "purify"),
            (gentle, lz_penalty, base_step + iterations, "settle"),
        ]
    return [(0.0, lz_penalty, base_step + iterations, "settle")]


def phase_overrides(
    *, base_seed: int, m: int, level: int, phase_index: int,
    l2_value: float, lz_value: float, iteration_target: int,
    run_dir: str, restore: str | None, orthogonal: list[str],
    overlap_penalty: float, l2_center: float = 0.0, l2_adaptive: bool = False,
    lr_delay: float | None = None,
) -> dict:
    """Config overrides for one phase of one sector run.

    Only the first phase restores from the warm-start checkpoint: an explicit
    ``restore_path`` takes precedence over the run's own save dir (LogManager
    contract, ``deephall_tpu/log.py``), so later phases must clear it to
    resume the previous phase instead of rewinding to the ground state.

    ``lr_delay`` rewrites the LR schedule's decay constant for this phase
    (settle legs only, see ``--settle-lr-delay``): warm-started sector runs
    carry step counters of 50-70k from the accumulated escape/purify/rail
    history, where the default ``rate/(1 + t/2000)`` schedule has decayed to
    ~0.0015 — the round-5 sweep measured sector 4's settle leg descending at
    only -2.3e-3/1k steps there, too slow to close a 0.05 energy gap inside
    any extension budget.  A larger ``delay`` keeps the settle leg in the
    productive LR band (~0.005) that every converged production tail trained
    at.  The value is shared across sectors and extensions.
    """
    overrides = {
        "seed": base_seed + 101 * m + level,
        "system": {
            "lz_center": float(m),
            "lz_penalty": lz_value,
            "l2_penalty": l2_value,
            "l2_center": l2_center,
            "l2_adaptive": l2_adaptive,
            "orthogonal_states": orthogonal,
            "overlap_penalty": overlap_penalty,
            # The penalty scalars ride into the iteration block as device
            # operands (train.penalty_operands), as in the JAX driver.
            "dynamic_penalties": True,
        },
        "optim": {"iterations": iteration_target},
        "log": {
            "save_path": run_dir,
            "restore_path": restore if phase_index == 0 else None,
        },
    }
    if lr_delay is not None:
        overrides["optim"]["kfac"] = {"lr": {"delay": lr_delay}}
        overrides["optim"]["adam"] = {"lr": {"delay": lr_delay}}
    return overrides


def tail_stats(
    csv_path: Path, rows: int, min_step: int | None = None,
    window: float = 0.05, drift_rows: int = 0,
) -> dict[str, float]:
    """Robust tail statistics of a train_stats.csv, sliced by *step number*.

    ``min_step`` restricts the window to rows of the final phase: StatsWriter
    appends across phases (and across driver re-launches), so a row-count
    slice from the CSV end can silently average escape-phase rows (4x Lz
    kick, no selector) into the dispersion point.  Step-number slicing is
    robust to both multi-phase runs and resumed runs with duplicated step
    ranges (the last ``rows`` filtered rows win by recency).

    Node-crossing spike rows are dropped by the BASELINE.md methodology (a
    ``window`` band around the tail's *median* energy): the per-step CSV
    keeps the unclipped local-energy mean, and a single walker crossing a
    node logs |E| up to ~1e4 with L^2 up to ~1e6 — one such row pushed a
    crude tail mean to L^2 = 1268 vs a robust 9.6 (runs/roton13 sector 2),
    which would both corrupt the dispersion point and make the purity rail
    extend a converged stage.  The spike mask comes from the energy column
    and is applied to every reported column (a spiked row is unusable in
    all of them); the energy error bar is blocked (20 blocks).
    """
    with open(csv_path) as f:
        table = list(csv.DictReader(f))
    if min_step is not None:
        filtered = [r for r in table if int(float(r["step"])) >= min_step]
        # A crashed-and-resumed phase can have fewer rows than planned; fall
        # back to the unfiltered tail rather than produce an empty window.
        table = filtered or table
    drift = drift_err = float("nan")
    if drift_rows:
        # Energy drift over a wider window than the mean (slope noise scales
        # as n^{-3/2}): robust linear fit of the spike-masked energies, per
        # 1000 steps, with its standard error so the convergence gate can
        # demand the drift be both small AND significant before failing a row.
        wide = table[-max(drift_rows, rows):]
        steps_w = np.array([float(r["step"]) for r in wide])
        energy_w = np.array([float(r["energy"]) for r in wide])
        keep_w = np.isfinite(energy_w) & (
            np.abs(energy_w - np.median(energy_w[np.isfinite(energy_w)]))
            <= window
        )
        if keep_w.sum() > 10:
            x = steps_w[keep_w] - steps_w[keep_w].mean()
            y = energy_w[keep_w]
            slope = float((x * (y - y.mean())).sum() / (x**2).sum())
            resid = y - y.mean() - slope * x
            se = float(
                np.sqrt((resid**2).sum() / max(1, y.size - 2) / (x**2).sum())
            )
            drift, drift_err = slope * 1000.0, se * 1000.0
    tail = table[-rows:]

    def col(name):
        return np.array([float(r[name]) for r in tail])

    energy = col("energy")
    keep = np.isfinite(energy) & (
        np.abs(energy - np.median(energy[np.isfinite(energy)])) <= window
    )
    if not keep.any():  # pathological tail: fall back to finite rows only
        keep = np.isfinite(energy)

    def masked_mean(name):
        # Older CSVs log observables with a plain mean, so a row can carry a
        # finite energy but a NaN L_square (near-pole walker); mask per
        # column on top of the energy-window row mask.
        values = col(name)[keep]
        values = values[np.isfinite(values)]
        return float(values.mean()) if values.size else float("nan")

    energy = energy[keep]
    nblocks = max(2, min(20, energy.size))
    block_means = [b.mean() for b in np.array_split(energy, nblocks)]
    out = {
        "energy": float(energy.mean()),
        "energy_err": float(
            np.std(block_means, ddof=1) / np.sqrt(len(block_means))
        ),
        "variance": float(np.nanmedian(col("variance")[keep])),
        "L_square": masked_mean("L_square"),
        "Lz": masked_mean("Lz"),
    }
    if drift_rows:
        out["drift"], out["drift_err"] = drift, drift_err
    if tail and "overlap" in tail[-1]:
        out["overlap"] = masked_mean("overlap")
    return out


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--config", required=True, help="config.yml of the ground run")
    parser.add_argument("--out", required=True, help="output directory for sector runs")
    parser.add_argument("--sectors", type=int, nargs="+", default=[2, 3, 4, 5])
    parser.add_argument("--iterations", type=int, default=20000,
                        help="iterations per sector run (on top of any warm start)")
    parser.add_argument(
        "--restore", default=None,
        help="checkpoint to warm-start each sector run from (the converged "
        "ground run). Measured necessary: from-scratch training against the "
        "sector penalties stalls in penalty-dominated local optima, while a "
        "warm-started run only has to climb out of the Lz=0 sector "
        "(BASELINE.md round 3). Chained states warm-start from the previous "
        "state in their chain.",
    )
    parser.add_argument("--lz-penalty", type=float, default=1.0)
    parser.add_argument(
        "--selector", choices=["adaptive", "onesided", "window"],
        default="onesided",
        help="L^2 selector form. 'onesided' (default) floors the penalty at "
        "the target multiplet via system.l2_center = m(m+1): inside the "
        "Lz = m sector every state has L >= m, so the gated penalty equals "
        "the unbiased linear selector and vanishes exactly at the target, "
        "and it stays on during the escape stage (zero at the ground, "
        "suppresses the high-L overshoot). The tunneling window still binds "
        "while <L^2> sits above the floor (measured: k=2.0 at m=2 drifted "
        "Lz 2 -> 1.31), so the purify stage raises the Lz penalty to 3*k*m "
        "to keep the requested k stable (see stable_lz). 'window' is the "
        "legacy two-sided selector with the k < 0.8*lz_penalty/(2m) clamp. "
        "'adaptive' (config.System.l2_adaptive) anneals the stiffness "
        "in-graph each step — k_eff = k * clip(<L^2> - c, 0, 1), Lz penalty "
        "raised to 3*m*k_eff — merging purify and settle into one "
        "self-annealing leg; built for the hard sectors whose L = m member "
        "is NOT the lowest state of its Lz window (N=6 sectors 2/3: a "
        "constant gentle k measured unable to hold the state against the "
        "energy drift toward the L=4 roton minimum, a constant stiff k "
        "measured wrecking the energy).",
    )
    parser.add_argument(
        "--l2-penalty", type=float, default=None,
        help="L^2 penalty selecting the L = m member of sector Lz = m: it is "
        "the sector's minimum-L^2 state, and a linear combination E + k<L^2> "
        "is extremal on an eigenstate (vertex of the convex hull), so the "
        "measured energy stays unbiased. Default 1.0 for --selector "
        "onesided (stabilized by the purify-stage Lz scaling, stable_lz), "
        "0.1 for the two-sided window "
        "(measured at N=4: k must exceed gap/within-sector-L^2-spacing to "
        "purify, but stay BELOW lz_penalty/(2 m) or the L^2 term overwhelms "
        "the Lz mismatch and the run escapes into a lower-L sector — k=0.5 "
        "sent the Lz=3 run to the L=2, Lz=2 state; the driver clamps to "
        "0.8*lz_penalty/(2 m) per sector). Set 0 to fall back to "
        "lowest-in-sector + --chain.",
    )
    parser.add_argument(
        "--overlap-penalty", type=float, default=1.0,
        help="penalty strength for --chain second states (must exceed the gap)",
    )
    parser.add_argument(
        "--chain", type=int, default=0,
        help="extra states per sector, each orthogonal to the previous ones",
    )
    parser.add_argument("--tail", type=int, default=500, help="stats tail rows")
    parser.add_argument(
        "--l2-tol", type=float, default=0.1,
        help="L^2-purity row gate: the settle tail's <L^2> must sit within "
        "this distance of the exact multiplet value m(m+1), else the sector "
        "is extended (burst + fresh settle) and ultimately marked failed "
        "(measured at N=4: a fixed budget left sector 2 at L^2 = 6.30 vs "
        "exact 6 — 5%% impurity biasing the energy by ~1 mHa). Set <= 0 to "
        "disable the whole gate.",
    )
    parser.add_argument(
        "--max-variance", type=float, default=0.05,
        help="row gate: maximum local-energy variance of the settle tail — "
        "an eigenstate has zero; the converged N=6 ground state measures "
        "0.005 and the round-4 unconverged sector rows 0.29-1.1, so a row "
        "above this is a mixture, not a measurement.",
    )
    parser.add_argument(
        "--drift-tol", type=float, default=1e-3,
        help="row gate: maximum settle-tail energy drift per 1000 steps. A "
        "row fails only when the fitted drift exceeds this AND its own "
        "2-sigma fit error (pure MC noise on a converged tail must not fail "
        "the gate).",
    )
    parser.add_argument(
        "--settle-lr-delay", type=float, default=None,
        help="LR-schedule delay constant for settle legs (and gentle "
        "extension legs). Warm-started sector runs carry 50-70k-step "
        "counters where the default delay=2000 schedule has decayed to "
        "~0.0015 — measured round 5: sector 4's settle drifted at only "
        "-2.3e-3/1k steps, unable to close its 0.05 energy gap in any "
        "extension budget. 8000 keeps settle legs near the ~0.005 band "
        "every converged production tail trained at. Stiff escape/purify/"
        "burst legs keep the default schedule (their stability was measured "
        "there). The value is shared across sectors.",
    )
    parser.add_argument(
        "--max-extend", type=int, default=3,
        help="maximum purify-stage extensions (each iterations//4) before "
        "accepting the sector as-is; from the second extension on, the L^2 "
        "selector strength is raised 1.5x (clamped to the stability window)",
    )
    parser.add_argument(
        "--dotlist", nargs="*", default=[],
        help="extra key=value overrides applied to every sector run",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="torch device of every sector run (default: cuda; cpu only when asked)",
    )
    args = parser.parse_args(argv)

    # Import late, so that the planning functions import without torch.
    from deephall_tpu_torch.config import Config, dotlist_to_dict, merge_dicts
    from deephall_tpu_torch.train import train
    from deephall_tpu_torch.utils import resolve_device

    device = resolve_device(args.device)  # no card: raise before any sector

    with open(args.config, encoding="utf8") as f:
        base = yaml.safe_load(f)
    base.pop("git_commit", None)
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    dispersion = out_dir / "dispersion.csv"

    def checkpoint_step(path: str) -> int:
        return int(np.load(path, allow_pickle=True)["step"]) + 1

    def drop_nonfinite_checkpoints(run_dir: Path) -> int:
        """Delete trailing checkpoints whose params are non-finite.

        The NaN abort path saves the blown-up state *before* raising
        (train.py), so a retry that resumed the newest checkpoint would
        restart inside the NaN; scan newest-first and stop at the first
        finite checkpoint.  Returns the number of checkpoints dropped (zero
        distinguishes a graceful SIGTERM abort from a NaN abort).
        """
        dropped = 0
        for path in sorted(run_dir.glob("ckpt_*.npz"), reverse=True):
            with np.load(path, allow_pickle=True) as f:
                params = f["params"].tolist()
            if all_finite(params):
                break
            print(f"    dropping non-finite checkpoint {path}", flush=True)
            path.unlink()
            dropped += 1
        return dropped

    def ed_sector_info(cfg, m: int, max_dim: int = 20000):
        """Exact ``Lz = m`` block structure, where ED is feasible.

        Returns ``{energy, l2, state, totals, l2s}`` for the ``L = m`` member
        (total energies / L^2 of the block's lowest states, ascending) or
        ``None`` (block bigger than ``max_dim``, or no ``L = m`` state among
        the lowest few).  Beyond anchoring the row, the block structure picks
        the settle-stage selector strength (:func:`settle_k_from_ed`): a
        target that IS the block ground state needs no selector, and a hard
        sector's needed stiffness follows from the exact margins.
        """
        from deephall_tpu_torch.observables import ed

        nelec = sum(cfg.system.nspins)
        two_q = abs(cfg.system.flux)
        # Counting DP, not the full lz_basis enumeration: the N=10 production
        # blocks have ~1e5 states out of 13M combinations, and this guard must
        # not stall the driver for minutes just to return None.
        if ed.lz_block_dim(two_q + 1, nelec, 2 * m) > max_dim:
            return None
        result = ed.ed_block(
            nelec, two_q, interaction=str(cfg.system.interaction_type),
            two_lz=2 * m, radius=cfg.system.radius, num_states=8,
        )
        l2s = [ed.state_l2(result, two_q, k) for k in range(len(result.energies))]
        totals = [
            nelec / 2.0 + cfg.system.interaction_strength * float(e)
            for e in result.energies
        ]
        for k, l2 in enumerate(l2s):
            if abs(l2 - m * (m + 1)) < 0.5:
                return {
                    "energy": totals[k], "l2": l2, "state": k,
                    "totals": totals, "l2s": l2s,
                }
        return None

    # The ground state is an orthogonality rail for every sector run: the
    # targets live in other Lz sectors, so the penalty is exactly zero at
    # convergence (no bias) but blocks the measured failure mode where the
    # purify stage's L^2 descent overshoots back into the ground basin.
    anchor = [args.restore] if args.restore else []

    # Re-launch safety (a sweep may be cut short): sectors whose row
    # already landed in dispersion.csv are skipped outright, and a partially
    # trained sector resumes its own run instead of rewinding to the ground
    # checkpoint and appending fresh escape-phase rows to its stats.
    done_rows: set[tuple[str, str]] = set()
    if dispersion.exists():
        with open(dispersion) as f:
            done_rows = {(r["sector"], r["level"]) for r in csv.DictReader(f)}

    one_sided = args.selector == "onesided"
    adaptive = args.selector == "adaptive"
    cfg_probe = Config.from_dict(
        merge_dicts(dict(base), dotlist_to_dict(args.dotlist))
    )
    if args.l2_penalty is None:
        # Adaptive default 2.0: this is the stiffness CAP (reached a full
        # unit above the target multiplet), and the equilibrium impurity
        # scales as 1/k — k = 2.0 measured rotating well once the in-graph
        # Lz raise holds the tunneling window.
        args.l2_penalty = 2.0 if adaptive else (1.0 if one_sided else 0.1)

    for m in args.sectors:
        # Two-sided window only: keep the selector inside its stability
        # window per sector — tunneling from (L=m, Lz=m) to (L=m-1, Lz=m-1)
        # costs lz_penalty but saves 2*m*k of L^2 penalty, so k must stay
        # below lz_penalty/(2m); with one global k the upper edge binds at
        # the OUTERMOST sector (0.1 would already tunnel at m >= 5).  The
        # one-sided floor keeps the full k by raising the purify-stage Lz
        # penalty instead (stable_lz, inside plan_phases).
        l2_penalty = args.l2_penalty
        k_bound = float("inf")
        if l2_penalty and m > 0 and args.selector == "window":
            k_bound = 0.8 * args.lz_penalty / (2.0 * m)
            if l2_penalty > k_bound:
                print(
                    f"sector {m}: clamping l2_penalty {l2_penalty} -> "
                    f"{k_bound:.4f} (stability window k < lz_penalty/2m)",
                    flush=True,
                )
                l2_penalty = k_bound
        l2_center = (
            float(m * (m + 1)) if (one_sided or adaptive) and l2_penalty else 0.0
        )
        # Exact block structure: row anchor + ED-informed settle stiffness.
        ed_info = ed_sector_info(cfg_probe, m) if l2_penalty else None
        k_settle_value = (
            settle_k_from_ed(
                ed_info["totals"], ed_info["l2s"], ed_info["state"],
                m, args.lz_penalty,
            )
            if ed_info is not None
            else None
        )
        if ed_info is not None:
            print(
                f"sector {m}: ED target E = {ed_info['energy']:.5f} "
                f"(block state {ed_info['state']}), settle k = "
                f"{k_settle_value:.4f}",
                flush=True,
            )
        previous: list[str] = []
        for level in range(args.chain + 1):
            name = f"sector_{m}" if level == 0 else f"sector_{m}_state{level}"
            run_dir = out_dir / name
            if (str(m), str(level)) in done_rows:
                print(f"=== sector Lz={m} state {level}: already in "
                      f"{dispersion}, skipping", flush=True)
                ckpts = sorted(run_dir.glob("ckpt_*.npz"))
                if ckpts:
                    previous = [*previous, str(ckpts[-1])]
                continue
            # Warm start: level 0 from the ground run, level k from the state
            # it must become orthogonal to.  The driver keeps the restored step
            # counter, so the iteration target is shifted accordingly.
            restore = previous[-1] if previous else args.restore
            base_step = checkpoint_step(restore) if restore else 0
            phases = plan_phases(
                level, l2_penalty, args.lz_penalty, base_step,
                args.iterations, one_sided=one_sided, m=m, adaptive=adaptive,
                settle_k_value=k_settle_value,
            )
            settle_len = phases[-1][2] - (
                phases[-2][2] if len(phases) > 1 else base_step
            )
            # A prior launch may have trained part of this sector: resume the
            # run's own checkpoints (an explicit restore_path would rewind to
            # the ground and append escape-phase rows) and skip phases whose
            # iteration target was already reached.  A resume point beyond the
            # whole plan (a re-launch with a smaller --iterations, or a prior
            # launch's rail extensions) gets a fresh settle leg: the restored
            # state has been through escape/purify already, and the dispersion
            # row must come from gentle-penalty rows trained at this HEAD.
            existing = sorted(run_dir.glob("ckpt_*.npz"))
            resume_step = checkpoint_step(str(existing[-1])) if existing else None
            if resume_step is not None:
                print(f"    resuming own run at step {resume_step}", flush=True)
                remaining = [p for p in phases if p[2] > resume_step]
                if not remaining:
                    settle = phases[-1]
                    remaining = [(settle[0], settle[1],
                                  resume_step + settle_len, "settle")]
                phases = remaining
            print(f"=== sector Lz={m} state {level} -> {run_dir}", flush=True)

            def run_phase(cfg_overrides: dict, retries: int = 2):
                """One train() phase, riding out NaN aborts.

                Measured in the N=6 sweep: the 4x escape kick at m=4 blew the
                parameters up to NaN ~1750 steps in, and train()'s SystemExit
                abort killed the remaining sectors of the sweep.  On a NaN
                abort (identified by a non-finite newest checkpoint — a
                graceful SIGTERM abort saves a finite one and must still
                stop the driver), drop the poisoned checkpoints, halve both
                penalty scalars (stiffness is what diverged), and resume the
                run's own last finite checkpoint (or the original warm start
                if none survived).
                """
                for attempt in range(retries + 1):
                    merged = merge_dicts(
                        merge_dicts(dict(base), cfg_overrides),
                        dotlist_to_dict(args.dotlist),
                    )
                    cfg = Config.from_dict(merged)
                    try:
                        train(cfg, device)
                        return cfg
                    except SystemExit as err:
                        if not drop_nonfinite_checkpoints(run_dir):
                            raise  # graceful shutdown, not a NaN abort
                        if attempt >= retries:
                            raise PhaseDiverged(
                                f"phase still NaN after {retries} retries"
                            ) from err
                        system = dict(cfg_overrides.get("system", {}))
                        system["lz_penalty"] = system.get("lz_penalty", 0) / 2
                        system["l2_penalty"] = system.get("l2_penalty", 0) / 2
                        cfg_overrides = {**cfg_overrides, "system": system}
                        # Resume the run's own last finite checkpoint; if the
                        # drop removed them all, fall back to the sector's
                        # warm start (restore_path=None would train a fresh
                        # random init against the full penalties).
                        cfg_overrides["log"] = {
                            **cfg_overrides.get("log", {}),
                            "restore_path": (
                                None if sorted(run_dir.glob("ckpt_*.npz"))
                                else restore
                            ),
                        }
                        print(
                            f"    NaN abort: retrying with lz_penalty="
                            f"{system['lz_penalty']}, l2_penalty="
                            f"{system['l2_penalty']}",
                            flush=True,
                        )

            cfg = None
            sector_failed = False
            settle_start = base_step
            phase_start = resume_step if resume_step is not None else base_step
            for phase_index, (l2_value, lz_value, iteration_target, kind) in (
                enumerate(phases)
            ):
                overrides = phase_overrides(
                    base_seed=int(base.get("seed", 1)), m=m, level=level,
                    phase_index=phase_index, l2_value=l2_value,
                    lz_value=lz_value, iteration_target=iteration_target,
                    run_dir=str(run_dir),
                    restore=None if resume_step is not None else restore,
                    orthogonal=anchor + previous,
                    overlap_penalty=args.overlap_penalty,
                    l2_center=l2_center if l2_value else 0.0,
                    # The settle leg is always fixed-gentle: the adaptive
                    # selector's equilibrium impurity keeps it stiff forever
                    # (see settle_k_from_ed), so the row is never measured
                    # under it.
                    l2_adaptive=adaptive and bool(l2_value) and kind != "settle",
                    lr_delay=(
                        args.settle_lr_delay if kind == "settle" else None
                    ),
                )
                if kind == "settle":
                    settle_start = phase_start
                phase_start = iteration_target
                try:
                    cfg = run_phase(overrides)
                except PhaseDiverged as err:  # persistent NaN: skip the sector
                    print(f"=== sector Lz={m} state {level} FAILED: {err}",
                          flush=True)
                    sector_failed = True
                    break
            if sector_failed:
                break  # abandon this sector's chain; continue the sweep

            # Row-quality gate (round-4 verdict: an unconverged tail must
            # never be published as a dispersion point — the sector-4 row
            # landed at E 0.22 above exact with variance 0.29 and no signal
            # it was garbage).  The settle tail must be pure, in-sector,
            # low-variance, and drift-free; a failing sector is extended —
            # a purity failure gets a stiff purify *burst* (fast rotation;
            # adaptive selector when requested) followed by a fresh gentle
            # settle leg, while a variance/drift failure just trains the
            # settle leg longer — and a sector still failing after
            # --max-extend extensions is appended with an explicit
            # ``status=failed(...)`` marker instead of silently polluting
            # the CSV.
            cur_target = phases[-1][2]
            stats_csv = run_dir / "train_stats.csv"

            def settle_stats() -> dict[str, float]:
                return tail_stats(
                    stats_csv,
                    min(args.tail, max(1, cur_target - settle_start)),
                    min_step=settle_start,
                    drift_rows=min(
                        4 * args.tail, max(2, cur_target - settle_start)
                    ),
                )

            def gate_failures(stats: dict[str, float]) -> list[str]:
                fails = []
                if abs(stats["L_square"] - m * (m + 1)) > args.l2_tol:
                    fails.append("l2")
                if abs(stats["Lz"] - m) > 0.05:
                    fails.append("lz")
                if not stats["variance"] <= args.max_variance:
                    fails.append("variance")
                drift = stats.get("drift", float("nan"))
                # Fail only a *significant* drift: the fit error on a short
                # noisy tail exceeds the tolerance, and a converged row must
                # not fail on MC noise.
                if (np.isfinite(drift) and abs(drift) > args.drift_tol
                        and abs(drift) > 2 * stats.get("drift_err", 0.0)):
                    fails.append("drift")
                return fails

            stats = settle_stats()
            gated = level == 0 and l2_penalty and args.l2_tol > 0
            status = ""
            if gated:
                fails = gate_failures(stats)
                k_gentle = (
                    k_settle_value if k_settle_value is not None
                    else (settle_k(l2_penalty, m, args.lz_penalty)
                          if one_sided else l2_penalty)
                )
                for extension in range(args.max_extend):
                    if not fails:
                        break
                    settle_ext = max(1, args.iterations // 4)
                    legs = []
                    # Easy sectors (the L = m member IS the Lz = m block
                    # ground state, ED-verified) never burst: plain energy
                    # minimization is itself the purifier there — every
                    # contaminant is higher-energy — while a stiff burst
                    # stalls the energy (measured round 4).  L^2 wandering
                    # above target mid-descent is transient mixing that the
                    # continued settle drains together with the variance.
                    easy = ed_info is not None and ed_info["state"] == 0
                    if ("l2" in fails or "lz" in fails) and not easy:
                        burst_len = max(1, args.iterations // 8)
                        if adaptive:
                            burst = (l2_penalty, args.lz_penalty,
                                     cur_target + burst_len, True)
                        elif one_sided:
                            cur_k = min(l2_penalty * 1.5**extension,
                                        2.0 * l2_penalty)
                            burst = (cur_k,
                                     stable_lz(cur_k, m, args.lz_penalty),
                                     cur_target + burst_len, False)
                        else:
                            cur_k = min(k_gentle * 1.5**extension, k_bound)
                            burst = (cur_k, args.lz_penalty,
                                     cur_target + burst_len, False)
                        legs.append(burst)
                        settle_start = cur_target + burst_len
                        legs.append((k_gentle, args.lz_penalty,
                                     cur_target + burst_len + settle_ext,
                                     False))
                    else:
                        # Pure variance/drift failure: the state is in-sector
                        # but not converged — just train the settle leg
                        # longer (same gentle penalties).
                        legs.append((k_gentle, args.lz_penalty,
                                     cur_target + settle_ext, False))
                    print(
                        f"    gate failed ({', '.join(fails)}): E = "
                        f"{stats['energy']:.5f}, L^2 = "
                        f"{stats['L_square']:.3f}, var = "
                        f"{stats['variance']:.3f}, drift = "
                        f"{stats.get('drift', float('nan')):.2e}/1k; "
                        f"extension {extension + 1}/{args.max_extend} to "
                        f"step {legs[-1][2]}",
                        flush=True,
                    )
                    extension_failed = False
                    for leg_index, (leg_k, leg_lz, leg_target, leg_adaptive) \
                            in enumerate(legs):
                        # Gentle legs (the fresh settle after a burst, or a
                        # plain variance/drift extension) are settle legs:
                        # they get the settle LR override.  Stiff burst legs
                        # keep the default schedule their stability was
                        # measured at.
                        gentle_leg = not leg_adaptive and leg_k <= k_gentle
                        try:
                            run_phase(phase_overrides(
                                base_seed=int(base.get("seed", 1)), m=m,
                                level=level,
                                phase_index=len(phases) + 2 * extension
                                + leg_index + 1,
                                l2_value=leg_k, lz_value=leg_lz,
                                iteration_target=leg_target,
                                run_dir=str(run_dir),
                                restore=None, orthogonal=anchor + previous,
                                overlap_penalty=args.overlap_penalty,
                                l2_center=l2_center,
                                l2_adaptive=leg_adaptive,
                                lr_delay=(
                                    args.settle_lr_delay if gentle_leg
                                    else None
                                ),
                            ))
                        except PhaseDiverged as err:  # persistent NaN
                            print(f"    extension FAILED ({err}); accepting "
                                  f"the sector at its current state",
                                  flush=True)
                            extension_failed = True
                            break
                        cur_target = leg_target
                    stats = settle_stats()
                    fails = gate_failures(stats)
                    if extension_failed:
                        break
                status = "ok" if not fails else "failed(" + "+".join(fails) + ")"

            ckpts = sorted(run_dir.glob("ckpt_*.npz"))
            previous = [*previous, str(ckpts[-1])]
            # StatsWriter appends across phases and launches; slice the tail
            # by step number so escape/purify rows (Lz kick, stiff selector)
            # are never averaged into the dispersion point — only the final
            # settle leg's gentle-penalty rows measure the sector energy.
            row = {"sector": m, "level": level, "status": status, **stats}
            if level == 0 and l2_penalty and ed_info is not None:
                # Exact anchor for the L = m member (small/medium blocks).
                row["ed_energy"] = ed_info["energy"]
                row["ed_l2"] = ed_info["l2"]
                row["ed_state"] = ed_info["state"]
            write_header = not dispersion.exists()
            with open(dispersion, "a", newline="") as f:
                writer = csv.DictWriter(
                    f,
                    fieldnames=[
                        "sector", "level", "energy", "energy_err", "variance",
                        "L_square", "Lz", "drift", "drift_err", "overlap",
                        "status", "ed_energy", "ed_l2", "ed_state",
                    ],
                    restval="",
                )
                if write_header:
                    writer.writeheader()
                writer.writerow(row)
            print(f"    {row}", flush=True)


if __name__ == "__main__":
    main()
