"""The port's dispersion report, ``scripts/dispersion_report_torch.py``, against ``scripts/dispersion_report.py``.

Every function on the same inputs as the JAX script (1e-10), at the sizes of
``tests/test_magnetoroton.py`` and ``tests/test_sma.py``: the merged table,
the rows rebuilt from sector CSVs, the exact sector anchors, the ED gaps and
the SMA bound (N=4, 2Q=9), and ``main``'s printed table.
"""

from __future__ import annotations

import contextlib
import csv
import io
import math
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import dispersion_report  # noqa: E402
import dispersion_report_torch  # noqa: E402

N, TWO_Q = 4, 9  # the nu=1/3 flux at N=4, as tests/test_sma.py
TOL = 1e-10
ROWS = [
    {"sector": "3", "level": "0", "energy": "3.9582", "energy_err": "0.0003",
     "L_square": "12.15", "ed_energy": "3.96467"},
    {"sector": "3", "level": "1", "energy": "4.1", "energy_err": "0.001",
     "L_square": "12.0", "ed_energy": ""},  # chained: skipped
    {"sector": "2", "level": "0", "energy": "4.0069", "energy_err": "0.0003",
     "L_square": "6.30", "ed_energy": "4.00300"},
    {"sector": "4", "level": "", "energy": "4.0201", "energy_err": "0.0004",
     "L_square": "20.4", "ed_energy": ""},
]


def same(got, want) -> None:
    """Equal structures, numbers to TOL."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            same(a, b)
    elif want is None:
        assert got is None
    elif isinstance(want, float):
        assert math.isclose(got, want, rel_tol=TOL, abs_tol=TOL) or (math.isnan(got) and math.isnan(want))
    else:
        assert got == want


def write_stats(path: Path, energy: float, last_step: int, l_square: float) -> None:
    """Append ten rows ending at ``last_step`` (a stage of a sector run)."""
    rows = [{"step": i, "energy": energy + 1e-4 * (i % 3), "variance": 0.01,
             "L_square": l_square, "Lz": 2.0, "overlap": 0.01}
            for i in range(last_step - 10, last_step)]
    exists = path.exists()
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        if not exists:
            writer.writeheader()
        writer.writerows(rows)


@pytest.fixture
def roton_dir(tmp_path):
    out = tmp_path / "roton"
    for m, (energy, l2) in {2: (7.002, 6.02), 4: (6.954, 20.04)}.items():
        d = out / f"sector_{m}"
        d.mkdir(parents=True)
        write_stats(d / "train_stats.csv", energy=5.0, last_step=50, l_square=999.0)
        write_stats(d / "train_stats.csv", energy=energy, last_step=100, l_square=l2)
    chained = out / "sector_2_state1"  # a higher band: not rebuilt
    chained.mkdir()
    write_stats(chained / "train_stats.csv", energy=7.2, last_step=100, l_square=6.0)
    return out


def test_report_equals_the_jax_script():
    same(dispersion_report_torch.report(ROWS, 3.8708, 1e-4),
         dispersion_report.report(ROWS, 3.8708, 1e-4))


def test_rebuild_rows_equals_the_jax_script(roton_dir):
    got = dispersion_report_torch.rebuild_rows(roton_dir, tail=10)
    assert [r["sector"] for r in got] == [2, 4]
    same(got, dispersion_report.rebuild_rows(roton_dir, tail=10))
    # With the exact anchors of each sector.
    same(dispersion_report_torch.rebuild_rows(roton_dir, tail=10, nelec=N, flux=TWO_Q),
         dispersion_report.rebuild_rows(roton_dir, tail=10, nelec=N, flux=TWO_Q))


@pytest.mark.parametrize("m", [1, 2, 3, 4])
def test_sector_ed_anchor_equals_the_jax_script(m):
    # The Lz = 1 block has no L = 1 state at nu = 1/3: both give None.
    got = dispersion_report_torch.sector_ed_anchor(N, TWO_Q, m)
    assert (got is None) == (m == 1)
    if got is not None:
        assert abs(got[1] - m * (m + 1)) < 0.5
    same(got, dispersion_report.sector_ed_anchor(N, TWO_Q, m))


def test_ed_gaps_and_sma_equal_the_jax_script():
    rows = [dict(r, ed_energy=r["ed_energy"] or "4.01") for r in ROWS]
    got = dispersion_report_torch.report(rows, 3.8708, 1e-4)
    want = dispersion_report.report(rows, 3.8708, 1e-4)
    same(dispersion_report_torch.attach_ed_gaps(got, N, TWO_Q),
         dispersion_report.attach_ed_gaps(want, N, TWO_Q))
    same(dispersion_report_torch.attach_sma(got, N, TWO_Q),
         dispersion_report.attach_sma(want, N, TWO_Q))
    same(got, want)
    assert all("gap_ed" in e for e in got) and any("gap_sma" in e for e in got)


def printed(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


def test_main_prints_the_jax_scripts_table(tmp_path, roton_dir):
    table = tmp_path / "dispersion.csv"
    with open(table, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(ROWS[0]))
        writer.writeheader()
        writer.writerows(ROWS)
    for argv in (
        [str(table), "--ground-energy", "3.8708", "--ground-err", "0.0001"],
        [str(table), "--ground-energy", "3.8708", "--nelec", str(N), "--flux", str(TWO_Q), "--sma"],
        [str(roton_dir), "--rebuild", "--tail", "10", "--ground-energy", "6.868",
         "--nelec", str(N), "--flux", str(TWO_Q)],
    ):
        text = printed(dispersion_report_torch.main, argv)
        assert text == printed(dispersion_report.main, argv)
        assert len(text.splitlines()) >= 4
