"""The port's sector driver, ``scripts/magnetoroton_torch.py``, against ``scripts/magnetoroton.py``.

* The copied planning functions (``escape_kick``, ``stable_lz``,
  ``settle_k_from_ed``, ``settle_k``, ``plan_phases``, ``phase_overrides``,
  ``tail_stats``) equal the JAX script's, exactly, over a grid of sector,
  selector strength, Lz penalty and selector form.
* ``main`` of both scripts with ``train`` patched (as in
  ``tests/test_magnetoroton.py``) on the same arguments gives the same
  sequence of stage configurations and the same ``dispersion.csv``: the
  sector chain, the purity rail, the NaN retry, the resume and skip-done
  relaunch, and the three selector forms.
* One real stage on the CPU: N=3, 2Q=4, a tiny Psiformer warm-started from a
  3-iteration KFAC ground run, sector Lz = 1 for 4 iterations.
"""

from __future__ import annotations

import csv
import importlib
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import magnetoroton  # noqa: E402
import magnetoroton_torch  # noqa: E402

from deephall_tpu import config as jax_config  # noqa: E402
from deephall_tpu_torch import config, train  # noqa: E402

SECTORS = (1, 2, 3, 4, 5, 6)
STRENGTHS = (0.0, 0.02, 0.1, 0.4, 1.0, 2.0)
LZ_PENALTIES = (0.5, 1.0, 3.0)


def test_scalar_planning_functions_equal():
    for m in (0, *SECTORS):
        for lz in LZ_PENALTIES:
            assert magnetoroton_torch.escape_kick(lz, m) == magnetoroton.escape_kick(lz, m)
            for k in STRENGTHS:
                assert magnetoroton_torch.stable_lz(k, m, lz) == magnetoroton.stable_lz(k, m, lz)
                assert magnetoroton_torch.settle_k(k, m, lz) == magnetoroton.settle_k(k, m, lz)


def test_settle_k_from_ed_equal():
    rng = np.random.default_rng(3)
    for m in SECTORS:
        for lz in LZ_PENALTIES:
            for target in range(4):
                energies = sorted(7.0 + rng.uniform(0, 0.3, 6))
                l2s = list(rng.choice([2.0, 6.0, 12.0, 20.0, 30.0, 42.0], 6))
                args = (energies, l2s, target, m, lz)
                assert (magnetoroton_torch.settle_k_from_ed(*args)
                        == magnetoroton.settle_k_from_ed(*args))


@pytest.mark.parametrize("selector", ["onesided", "window", "adaptive"])
def test_plan_phases_and_overrides_equal(selector):
    for m in SECTORS:
        for k in STRENGTHS:
            for lz in LZ_PENALTIES:
                for level in (0, 1):
                    for settle in (None, 0.05):
                        kwargs = dict(one_sided=selector == "onesided", m=m,
                                      adaptive=selector == "adaptive", settle_k_value=settle)
                        args = (level, k, lz, 50, 100)
                        plan = magnetoroton_torch.plan_phases(*args, **kwargs)
                        assert plan == magnetoroton.plan_phases(*args, **kwargs)
                        for index, (l2, lz_value, target, kind) in enumerate(plan):
                            overrides = dict(
                                base_seed=7, m=m, level=level, phase_index=index, l2_value=l2,
                                lz_value=lz_value, iteration_target=target, run_dir="/x",
                                restore="/g.npz", orthogonal=["/g.npz"], overlap_penalty=1.0,
                                l2_center=m * (m + 1.0), l2_adaptive=selector == "adaptive",
                                lr_delay=8000.0 if kind == "settle" else None)
                            assert (magnetoroton_torch.phase_overrides(**overrides)
                                    == magnetoroton.phase_overrides(**overrides))


def test_tail_stats_equal(tmp_path):
    rng = np.random.default_rng(5)
    path = tmp_path / "train_stats.csv"
    rows = [{"step": i, "energy": 7.1 + 0.01 * rng.standard_normal(), "variance": 0.2,
             "L_square": 6.0 + 0.1 * rng.standard_normal(), "Lz": 2.0, "overlap": 0.001}
            for i in range(200)]
    rows[57]["energy"], rows[71]["L_square"] = 3.2e4, float("nan")
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        writer.writeheader()
        writer.writerows(rows)
    for kwargs in ({"rows": 100}, {"rows": 50, "min_step": 120}, {"rows": 60, "drift_rows": 150},
                   {"rows": 10, "min_step": 500, "window": 0.02}):
        want = magnetoroton.tail_stats(path, **kwargs)
        assert magnetoroton_torch.tail_stats(path, **kwargs) == want


def _fake_stats(path: Path, last_step: int, l_square: float, lz: float) -> None:
    """``tests/test_magnetoroton.py:_fake_stats``: rows ending at ``last_step``."""
    rows = [{"step": i, "energy": 7.0, "variance": 0.01, "L_square": l_square, "Lz": lz,
             "overlap": 0.01} for i in range(max(0, last_step - 10), last_step)]
    exists = path.exists()
    with open(path, "a", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=list(rows[0]))
        if not exists:
            writer.writeheader()
        writer.writerows(rows)


def _fake_train(seen: list, l_squares: list, lz: float, nan_sector: str | None):
    """A ``train`` that records each stage's config, appends fake statistics and a
    checkpoint, and for ``nan_sector`` saves a NaN state and aborts."""
    good = np.array({"w": np.array([1.0])}, dtype=object)
    bad = np.array({"w": np.array([np.nan])}, dtype=object)

    def fake_train(cfg, device=None):
        del device
        seen.append(cfg)
        run_dir = Path(cfg.log.save_path)
        run_dir.mkdir(parents=True, exist_ok=True)
        if nan_sector and nan_sector in cfg.log.save_path:
            np.savez(run_dir / f"ckpt_{60 + len(seen):06d}.npz", step=60 + len(seen), params=bad)
            raise SystemExit("=" * 30 + " ABORT " + "=" * 30)
        l_square = l_squares[min(len(seen), len(l_squares)) - 1]
        _fake_stats(run_dir / "train_stats.csv", cfg.optim.iterations, l_square, lz)
        np.savez(run_dir / f"ckpt_{cfg.optim.iterations - 1:06d}.npz",
                 step=cfg.optim.iterations - 1, params=good)

    return fake_train


# (arguments after --config/--out/--restore, per-stage tail L^2, tail Lz, NaN sector,
# a previous launch to resume)
SCENARIOS = {
    "chain_window": (["--sectors", "2", "3", "--chain", "1", "--iterations", "123",
                      "--selector", "window", "--l2-penalty", "0.4", "--tail", "5",
                      "--l2-tol", "0", "--dotlist", "batch_size=512"], [12.0], 2.0, None, None),
    "purity_rail": (["--sectors", "2", "--iterations", "100", "--tail", "5",
                     "--selector", "window"], [12.0, 6.4, 6.3, 6.02], 2.0, None, None),
    "adaptive": (["--sectors", "2", "--iterations", "100", "--tail", "5",
                  "--selector", "adaptive"], [40.0, 12.0, 6.4, 6.3, 6.02], 2.0, None, None),
    "onesided": (["--sectors", "5", "--iterations", "100", "--tail", "5"],
                 [40.0, 31.0, 30.6, 30.2, 30.01], 5.0, None, None),
    "nan_retry": (["--sectors", "4", "5", "--iterations", "100", "--tail", "5", "--l2-tol", "0"],
                  [30.0], 5.0, "sector_4", None),
    "relaunch": (["--sectors", "2", "--iterations", "100", "--tail", "5", "--l2-tol", "0"],
                 [6.0], 2.0, None, 120),
}


def _run_driver(package: str, module, tmp_path: Path, monkeypatch, scenario: str):
    argv, l_squares, lz, nan_sector, resumed = SCENARIOS[scenario]
    cfg_module = jax_config if package == "deephall_tpu" else config
    base = cfg_module.Config()
    base.seed, base.system.flux, base.system.nspins = 7, 15, (6, 0)
    tmp_path.mkdir()
    config_yml = tmp_path / "config.yml"
    config_yml.write_text(yaml.safe_dump(cfg_module.to_dict(base)))
    ground = tmp_path / "ground_ckpt_000049.npz"
    np.savez(ground, step=49, params=np.array({"w": np.array([1.0])}, dtype=object))
    out = tmp_path / "roton"
    if resumed is not None:  # a previous launch died mid-purify
        (out / "sector_2").mkdir(parents=True)
        np.savez(out / "sector_2" / f"ckpt_{resumed:06d}.npz", step=resumed)
        _fake_stats(out / "sector_2" / "train_stats.csv", resumed + 1, l_squares[0], lz)
    seen: list = []
    monkeypatch.setattr(importlib.import_module(f"{package}.train"), "train",
                        _fake_train(seen, l_squares, lz, nan_sector))
    device = ["--device", "cpu"] if module is magnetoroton_torch else []
    args = ["--config", str(config_yml), "--out", str(out), "--restore", str(ground), *argv,
            *device]
    module.main(args)
    if scenario == "relaunch":  # the row is in dispersion.csv: a no-op
        module.main(args)
    with open(out / "dispersion.csv") as f:
        rows = list(csv.DictReader(f))
    return [cfg_module.to_dict(c) for c in seen], rows


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_main_equals_the_jax_driver(tmp_path, monkeypatch, scenario):
    want = _run_driver("deephall_tpu", magnetoroton, tmp_path / "jax", monkeypatch, scenario)
    got = _run_driver("deephall_tpu_torch", magnetoroton_torch, tmp_path / "torch",
                      monkeypatch, scenario)
    jax_root, torch_root = str(tmp_path / "jax"), str(tmp_path / "torch")
    want_configs = yaml.safe_load(yaml.safe_dump(want[0]).replace(jax_root, torch_root))
    assert got[0] == want_configs
    assert got[1] == want[1]
    assert got[1] and all(row["sector"] for row in got[1])


def test_main_raises_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        magnetoroton_torch.main(["--config", str(tmp_path / "config.yml"),
                                 "--out", str(tmp_path / "out"), "--sectors", "1"])


def test_one_real_stage_on_the_cpu(tmp_path):
    tiny = ["seed=3", "batch_size=32", "system.nspins=[3,0]", "system.flux=4",
            "network.psiformer.num_layers=1", "network.psiformer.num_heads=1",
            "network.psiformer.heads_dim=4", "mcmc.burn_in=5", "mcmc.steps=2",
            "log.initial_energy=false", "optim.optimizer=kfac"]
    ground = tmp_path / "ground"
    train.cli([*tiny, "optim.iterations=3", f"log.save_path={ground}", "--device", "cpu"])
    out = tmp_path / "roton"
    magnetoroton_torch.main([
        "--config", str(ground / "config.yml"), "--restore", str(ground / "ckpt_000002.npz"),
        "--out", str(out), "--sectors", "1", "--iterations", "4", "--tail", "2",
        "--l2-penalty", "0", "--device", "cpu"])
    with open(out / "sector_1" / "train_stats.csv") as f:
        steps = [int(row["step"]) for row in csv.DictReader(f)]
    assert steps == [3, 4, 5, 6]  # one settle stage from the warm start's step
    assert (out / "sector_1" / "ckpt_000006.npz").exists()
    with open(out / "dispersion.csv") as f:
        rows = list(csv.DictReader(f))
    assert [(r["sector"], r["level"]) for r in rows] == [("1", "0")]
    assert all(np.isfinite(float(rows[0][k])) for k in ("energy", "variance", "L_square", "Lz"))
