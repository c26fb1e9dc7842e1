"""Magnetoroton dispersion report of the PyTorch port: VMC sector rows against the exact spectrum.

The port's copy of ``scripts/dispersion_report.py``, with the same command
line and functions, on the port's own exact diagonalization
(``deephall_tpu_torch.observables.ed``) and sector statistics
(``scripts/magnetoroton_torch.py:tail_stats``); it imports nothing of JAX.
It runs no model: it reads CSVs and diagonalises on the host.

Merges a ``dispersion.csv`` produced by ``scripts/magnetoroton_torch.py``
(or ``scripts/magnetoroton.py``) with the exact ED excitation spectrum of the
same system and a converged ground-state energy, and prints the per-sector
table used by BASELINE.md: gap_VMC = E_m - E0_VMC vs gap_ED = E_m^ED - E0^ED,
the sector's L^2 purity, and the VMC-ED energy deviation in units of the VMC
error bar.

The two gaps are the physical comparison (the smooth LL-mixing shift largely
cancels in the difference); the absolute VMC < ED ordering per row is the
variational LL-mixing signature every converged family shows (BASELINE.md).

Usage:
    python3 scripts/dispersion_report_torch.py runs/roton_n4e/dispersion.csv \
        --ground-energy 3.87080 --ground-err 0.00013
"""

from __future__ import annotations

import argparse
import csv


def report(rows: list[dict], e0_vmc: float, e0_err: float) -> list[dict]:
    """Build the merged dispersion table (pure function; tested on CPU)."""
    out = []
    ed_ground: float | None = None
    for r in rows:
        if r.get("level") not in ("", None) and int(r["level"]) != 0:
            continue  # chained higher bands have no selector/ED anchor
        entry = {
            "L": int(r["sector"]),
            "energy": float(r["energy"]),
            "energy_err": float(r["energy_err"]),
            "L_square": float(r["L_square"]),
            "gap_vmc": float(r["energy"]) - e0_vmc,
        }
        exact_l2 = entry["L"] * (entry["L"] + 1)
        entry["purity"] = abs(entry["L_square"] - exact_l2)
        if r.get("ed_energy"):
            entry["ed_energy"] = float(r["ed_energy"])
            entry["dev_sigma"] = (entry["energy"] - entry["ed_energy"]) / max(
                entry["energy_err"], 1e-12
            )
        out.append(entry)
    return sorted(out, key=lambda e: e["L"])


def attach_ed_gaps(entries: list[dict], nelec: int, flux: int) -> float | None:
    """Diagonalize the Lz=0 block for E0 and attach gap_ed per row."""
    from deephall_tpu_torch.observables import ed

    result = ed.ed_block(nelec, flux, two_lz=0, num_states=2)
    e0_ed = nelec / 2.0 + float(result.energies[0])
    for e in entries:
        if "ed_energy" in e:
            e["gap_ed"] = e["ed_energy"] - e0_ed
    return e0_ed


def sector_ed_anchor(
    nelec: int, flux: int, m: int, interaction: str = "coulomb",
    strength: float = 1.0,
):
    """Exact ``L = m`` member of the ``Lz = m`` block: ``(E_total, L^2, k)``."""
    from deephall_tpu_torch.observables import ed

    result = ed.ed_block(
        nelec, flux, interaction=interaction, two_lz=2 * m, num_states=8
    )
    for k in range(len(result.energies)):
        l2 = ed.state_l2(result, flux, k)
        if abs(l2 - m * (m + 1)) < 0.5:
            return nelec / 2.0 + strength * float(result.energies[k]), l2, k
    return None


def rebuild_rows(
    out_dir, tail: int = 1000, nelec: int | None = None,
    flux: int | None = None, interaction: str = "coulomb",
) -> list[dict]:
    """Recompute dispersion rows from each sector's own train_stats.csv.

    The CSVs are the ground truth; a sweep's dispersion.csv can predate a
    stats fix (the round-4 sweep wrote rows through a non-robust tail mean —
    one node-crossing spike row inflated a sector's L^2 column 130x) or a
    manual sector extension.  Rows are rebuilt from the final ``tail`` steps
    of each ``sector_<m>/`` run — always inside the final stage, since every
    stage and extension is at least ``iterations // 4 >= tail`` steps at
    production budgets — with the robust (median-window) methodology of
    ``magnetoroton_torch.tail_stats``.
    """
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent))
    import magnetoroton_torch

    rows = []
    for d in sorted(Path(out_dir).glob("sector_*")):
        name = d.name.split("_")
        if len(name) != 2 or not name[1].isdigit():
            continue  # chained higher-band runs (sector_m_stateK) have no selector
        m = int(name[1])
        stats_csv = d / "train_stats.csv"
        if not stats_csv.exists():
            continue
        with open(stats_csv) as f:
            table = list(csv.DictReader(f))
        if not table:
            continue
        last_step = int(float(table[-1]["step"]))
        stats = magnetoroton_torch.tail_stats(
            stats_csv, tail, min_step=last_step - tail + 1
        )
        row = {"sector": m, "level": 0, **stats}
        if nelec is not None and flux is not None:
            anchor = sector_ed_anchor(nelec, flux, m, interaction)
            if anchor is not None:
                row["ed_energy"], row["ed_l2"], row["ed_state"] = anchor
        rows.append(row)
    return rows


def attach_sma(entries: list[dict], nelec: int, flux: int) -> list[dict]:
    """Exact GMP single-mode-approximation gaps for the same sectors.

    ``ed.sma_spectrum`` measures ``rho_L |0>`` on the exact ground state —
    a variational upper bound per sector (``tests/test_sma.py``).  Attached
    as ``gap_sma`` where defined (``L = 1`` has no SMA state: the projected
    ``q -> 0`` density annihilates the incompressible ground state).
    """
    from deephall_tpu_torch.observables import ed

    lmax = max((e["L"] for e in entries), default=0)
    rows = ed.sma_spectrum(nelec, flux, lmax=lmax) if lmax else []
    by_l = {r["l"]: r for r in rows}
    for e in entries:
        row = by_l.get(e["L"])
        if row and row["sma_gap"] is not None:
            e["gap_sma"] = row["sma_gap"]
            e["sbar"] = row["sbar"]
    return rows


def save_figure(entries: list[dict], path: str, title: str) -> None:
    """Dispersion figure: VMC rows vs the exact spectrum vs the SMA bound.

    One axis (gap vs L); three series with fixed categorical colors plus
    marker-shape secondary encoding (dataviz skill reference palette, slots
    1-3 — documented to pass the all-pairs CVD checks in light mode).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    surface, text1, text2 = "#fcfcfb", "#0b0b0b", "#52514e"
    c_vmc, c_ed, c_sma = "#2a78d6", "#eb6834", "#1baf7a"

    fig, ax = plt.subplots(figsize=(6.4, 4.2), dpi=160)
    fig.patch.set_facecolor(surface)
    ax.set_facecolor(surface)

    ls = sorted(e["L"] for e in entries)
    by_l = {e["L"]: e for e in entries}
    sma = [(l, by_l[l]["gap_sma"]) for l in ls if "gap_sma" in by_l[l]]
    if sma:
        ax.plot(
            [p[0] for p in sma], [p[1] for p in sma], "^--", color=c_sma,
            lw=2, ms=8, label="SMA bound (exact $\\rho_L|0\\rangle$)",
            zorder=2,
        )
    ed_pts = [(l, by_l[l]["gap_ed"]) for l in ls if "gap_ed" in by_l[l]]
    if ed_pts:
        ax.plot(
            [p[0] for p in ed_pts], [p[1] for p in ed_pts], "s-",
            color=c_ed, lw=2, ms=8, label="exact diagonalization", zorder=3,
        )
    ax.errorbar(
        ls, [by_l[l]["gap_vmc"] for l in ls],
        yerr=[by_l[l]["energy_err"] for l in ls], fmt="o", color=c_vmc,
        ms=9, capsize=4, lw=2, label="VMC (this framework)", zorder=4,
    )
    ax.set_xlabel("angular momentum $L$", color=text1)
    ax.set_ylabel("excitation gap  $E_L - E_0$", color=text1)
    ax.set_title(title, color=text1, fontsize=11)
    ax.set_xticks(ls)
    ax.grid(True, color="#e6e5e1", lw=0.8, zorder=0)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(text2)
    ax.tick_params(colors=text2)
    legend = ax.legend(frameon=False, fontsize=9, labelcolor=text1)
    for h in legend.legend_handles:
        h.set_alpha(1.0)
    fig.tight_layout()
    fig.savefig(path, facecolor=surface)
    plt.close(fig)
    print(f"figure -> {path}")


def main(argv: list[str] | None = None) -> list[dict]:
    """The command line; returns the report's entries as printed."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "dispersion",
        help="dispersion.csv from magnetoroton_torch.py, or with --rebuild the "
        "sweep's --out directory (rows recomputed from the sector CSVs)",
    )
    parser.add_argument("--ground-energy", type=float, required=True,
                        help="converged VMC ground-state energy E0 (tail mean)")
    parser.add_argument("--ground-err", type=float, default=0.0)
    parser.add_argument("--nelec", type=int, default=None,
                        help="with --flux: also print exact ED gaps")
    parser.add_argument("--flux", type=int, default=None)
    parser.add_argument("--rebuild", action="store_true",
                        help="recompute rows from sector_*/train_stats.csv "
                        "(robust tails) instead of reading dispersion.csv")
    parser.add_argument("--tail", type=int, default=1000,
                        help="tail rows per sector for --rebuild")
    parser.add_argument("--sma", action="store_true",
                        help="with --nelec/--flux: attach the exact GMP "
                        "single-mode-approximation upper bound per sector")
    parser.add_argument("--figure", default=None,
                        help="write a dispersion PNG (VMC vs ED vs SMA)")
    parser.add_argument("--title", default=None, help="figure title")
    args = parser.parse_args(argv)

    if args.rebuild:
        rows = [
            {k: str(v) for k, v in r.items()}
            for r in rebuild_rows(
                args.dispersion, args.tail, args.nelec, args.flux
            )
        ]
    else:
        with open(args.dispersion) as f:
            rows = list(csv.DictReader(f))
    entries = report(rows, args.ground_energy, args.ground_err)
    e0_ed = None
    if args.nelec is not None and args.flux is not None:
        e0_ed = attach_ed_gaps(entries, args.nelec, args.flux)
        if args.sma:
            attach_sma(entries, args.nelec, args.flux)

    print(f"E0_VMC = {args.ground_energy:.5f} +- {args.ground_err:.5f}"
          + (f"   E0_ED = {e0_ed:.5f}" if e0_ed is not None else ""))
    hdr = f"{'L':>2} {'E_VMC':>10} {'err':>8} {'gap_VMC':>8}"
    hdr += f" {'gap_ED':>8} {'E_ED':>10} {'dev/sig':>8} {'|L2-L(L+1)|':>12}"
    if args.sma:
        hdr += f" {'gap_SMA':>8}"
    print(hdr)
    for e in entries:
        line = (
            f"{e['L']:>2} {e['energy']:>10.5f} {e['energy_err']:>8.5f} "
            f"{e['gap_vmc']:>8.5f} "
            f"{e.get('gap_ed', float('nan')):>8.5f} "
            f"{e.get('ed_energy', float('nan')):>10.5f} "
            f"{e.get('dev_sigma', float('nan')):>8.1f} "
            f"{e['purity']:>12.3f}"
        )
        if args.sma:
            line += f" {e.get('gap_sma', float('nan')):>8.5f}"
        print(line)

    if args.figure:
        nelec = args.nelec if args.nelec is not None else 0
        title = args.title or (
            f"magnetoroton dispersion, N={nelec}, 2Q={args.flux} "
            f"($\\nu=1/3$)"
        )
        save_figure(entries, args.figure, title)
    return entries


if __name__ == "__main__":
    main()
