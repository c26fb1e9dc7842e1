"""The port's inference statistics and CLI against the JAX package."""

from __future__ import annotations

import csv
import math
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import loss as jax_loss
from deephall_tpu.log import LogManager as JaxLogManager
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config, loss, train
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import load_flax, params_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "artifacts/prod_r4"
JAX_CSV_FIELDS = [
    "step", "pmove", "energy", "energy_imag", "potential", "kinetic", "variance",
    "Lz", "Lz_square", "L_square", "step_time",
]

PENALTIES = {
    "none": {},
    "lz": {"lz_penalty": 0.5, "lz_center": 1.0},
    "l2_gate": {"l2_penalty": 0.3, "l2_center": 0.2},
    "l2_adaptive": {"l2_penalty": 0.3, "l2_center": 0.5, "l2_adaptive": True,
                    "lz_penalty": 0.2, "lz_center": 2.0},
    "dynamic": {"dynamic_penalties": True, "lz_penalty": 0.1, "l2_penalty": 0.2},
}


def synthetic_observables(seed, batch=64):
    rng = np.random.default_rng(seed)
    el = (6.87 + 0.1 * rng.standard_normal(batch)
          + 0.01j * rng.standard_normal(batch)).astype(np.complex64)
    el[3] += 40.0  # an outlier for the clipping
    el[5] = np.nan
    obs = {
        "angular_momentum_z": 0.1 * rng.standard_normal(batch),
        "angular_momentum_z_square": np.abs(rng.standard_normal(batch)),
        "angular_momentum_square": 0.5 * np.abs(rng.standard_normal(batch)),
        "potential": 3.8 + 0.1 * rng.standard_normal(batch),
        "kinetic": (3.0 + 0.1 * rng.standard_normal(batch)
                    + 0.01j * rng.standard_normal(batch)).astype(np.complex64),
    }
    obs = {k: np.asarray(v, np.complex64 if np.iscomplexobj(v) else np.float32)
           for k, v in obs.items()}
    return el, obs


@pytest.mark.parametrize("variant", sorted(PENALTIES))
def test_stats_and_clipped_diff_match(variant):
    # Same inputs on both sides: only the order of the float32 sums differs.
    raw = {"system": {"compute_l2": True, **PENALTIES[variant]}}
    jsystem = jax_config.Config.from_dict(raw).system
    system = config.Config.from_dict(raw).system
    el, obs = synthetic_observables(len(variant))
    penalties = None
    if jsystem.dynamic_penalties:
        penalties = {k: jnp.float32(getattr(jsystem, k)) for k in (
            "lz_penalty", "lz_center", "l2_penalty", "l2_center", "overlap_penalty")}
    want_stats, want_diff = jax_loss.stats_and_clipped_diff(
        jsystem, jnp.asarray(el), {k: jnp.asarray(v) for k, v in obs.items()},
        penalties=penalties,
    )
    got_stats, got_diff = loss.stats_and_clipped_diff(
        system, torch.from_numpy(el), {k: torch.from_numpy(v) for k, v in obs.items()},
        penalties=None if penalties is None else {k: torch.tensor(float(v)) for k, v in penalties.items()},
    )
    assert sorted(got_stats) == sorted(want_stats)
    for key, want in want_stats.items():
        np.testing.assert_allclose(got_stats[key].numpy(), np.asarray(want), rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got_diff.numpy(), np.asarray(want_diff), rtol=1e-5, atol=1e-5)


def test_energy_diff_loss_on_artifact_walkers():
    # Whole ENERGY_DIFF path on 8 stored walkers; tolerances of
    # test_torch_energy.py (float32 second derivatives summed in another order).
    raw = yaml.safe_load((ARTIFACT / "config.yml").read_text())
    with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        params, data = f["params"].tolist(), np.asarray(f["data"][:8])
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    want_stats, want_diff = jax.jit(
        jax_loss.make_loss_fn(jmodel.apply, jcfg.system, jax_loss.LossMode.ENERGY_DIFF, model=jmodel)
    )(params, jnp.asarray(data))
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    got_stats, got_diff = loss.make_loss_fn(model, cfg.system)(torch.from_numpy(data))
    for key, want in want_stats.items():
        atol = 1e-3 if key == "angular_momentum_square" else 1e-4
        np.testing.assert_allclose(got_stats[key].numpy(), np.asarray(want), rtol=1e-4, atol=atol,
                                   err_msg=key)
    # diff_i = E_L,i - <E_L>: the E_L tolerance enters twice.
    np.testing.assert_allclose(got_diff.numpy(), np.asarray(want_diff), rtol=1e-4, atol=2e-4)


def test_cli_tiny_run_reads_back_in_jax(tmp_path):
    save = tmp_path / "run"
    cmd = [
        sys.executable, "-m", "deephall_tpu_torch.train", "seed=3", "batch_size=16",
        "system.nspins=[3,0]", "system.flux=2", "network.psiformer.num_layers=1",
        "network.psiformer.num_heads=1", "network.psiformer.heads_dim=4",
        "mcmc.burn_in=2", "optim.iterations=3", "optim.optimizer=none",
        f"log.save_path={save}", "--device", "cpu",
    ]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0, out.stderr
    with open(save / "train_stats.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == JAX_CSV_FIELDS
    assert [r[0] for r in rows[1:]] == ["0", "1", "2"]
    assert all(np.isfinite(float(r[2])) for r in rows[1:])
    step, state, adapt = JaxLogManager.restore_checkpoint(save / "ckpt_000002.npz")
    assert step == 3 and state.data.shape == (16, 3, 2) and state.opt_state is None
    assert int(adapt["t"]) == 3 and adapt["pmoves"].shape == (100,)
    assert set(state.params["params"]) == {"PsiformerLayers_0", "Orbitals_0", "Jastrow_0"}
    saved = yaml.safe_load((save / "config.yml").read_text())
    assert jax_config.Config.from_dict(saved).optim.optimizer == jax_config.OptimizerName.none


def test_cuda_requested_without_a_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = config.Config.from_dict({"log": {"save_path": str(tmp_path)}})
    with pytest.raises(RuntimeError, match="CUDA"):
        train.train(cfg, device="cuda")
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("optimizer", ["kfac", "adam"])
def test_training_optimizers_are_not_ported_yet(optimizer, tmp_path):
    # Both training optimizers are ported, and so is what they lacked: a fixed
    # lower state of the analytic network (system.orthogonal_states), whose
    # checkpoint has no parameters.  Two iterations of a small Psiformer
    # against a stored Laughlin state, with the overlap statistic finite.
    laughlin = config.Config.from_dict({
        "system": {"nspins": [3, 0], "flux": 6}, "network": {"type": "laughlin"},
        "log": {"save_path": str(tmp_path / "laughlin")}})
    model = make_network(laughlin.system, laughlin.network)
    data = torch.rand(8, 3, 2) * torch.tensor([math.pi, 2 * math.pi]) - torch.tensor([0, math.pi])
    LogManager(laughlin).save_checkpoint(
        0, CheckpointState(params_to_flax(model), data.numpy(), None, 0.1))
    cfg = config.Config.from_dict({
        "batch_size": 16, "optim": {"optimizer": optimizer, "iterations": 2},
        "mcmc": {"burn_in": 2}, "log": {"save_path": str(tmp_path / "run")},
        "system": {"nspins": [3, 0], "flux": 6,
                   "orthogonal_states": [str(tmp_path / "laughlin" / "ckpt_000000.npz")]},
        "network": {"psiformer": {"num_layers": 1, "num_heads": 1, "heads_dim": 4}},
    })
    history = train.train(cfg, device="cpu")
    assert len(history) == 2
    assert all(np.isfinite(row["overlap"]) and np.isfinite(row["energy"].real) for row in history)
