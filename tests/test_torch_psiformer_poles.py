"""The Psiformer's jet local energy with an electron at or near a pole.

The sampler's float32 ``arccos`` puts electrons exactly on a pole
(``float32(pi)``, 8.7e-8 past it, or 0) or at least 3.45e-4 from one.  In the
symmetric gauge the jet's Laplacian and L^2 rows carried terms of size
Q^2 / sin^2 theta that cancelled only at the end, so in float32 the kinetic
energy read -3.6e7 at ``float32(pi)`` and 12.8 against 3.0 at pi - 3.45e-4,
and every value was NaN at theta = 0.  The port's jet is now carried in the
gauge regular at each electron's nearer pole, along unit geodesics and
rotation flows (``hamiltonian.forward_laplacian_local_energy``).

On ``artifacts/prod_r4``'s stored walkers with electron 0 moved to the points
of ``scripts/torch_psiformer_pole_probe.py:pole_walkers`` (float32 pi,
pi - 3.4527e-4, pi - 1e-3, pi - 1e-2 at two phis, 3.4527e-4, 1e-3, 1e-2 and 0),
and on 8 ordinary stored walkers:

* the float32 evaluation against the same function with the model and the
  walkers in float64, at every pole walker: |KE|, |E_L| within 2e-3, |L^2|
  within 5e-3, |Lz| within 1e-3, every value finite;
* that float64 truth against the JAX package's jet local energy evaluated in
  float64 (``jax.enable_x64``), the symmetric-gauge formulas, where those are
  themselves exact enough (the ordinary walkers, and 1e-2 from a pole): E_L,
  KE, Lz and Lz^2 within 1e-6, L^2 within 1e-5.  So the repair computes the
  same quantity.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

from deephall_tpu import config as jax_config
from deephall_tpu.hamiltonian import forward_laplacian_local_energy as jax_local_energy
from deephall_tpu.networks import make_network as jax_make_network

torch.set_num_threads(2)

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "torch_psiformer_pole_probe.py"
SYMMETRIC_TOL = {"energy": 1e-6, "kinetic": 1e-6, "angular_momentum_z": 1e-6,
                 "angular_momentum_z_square": 1e-6, "angular_momentum_square": 1e-5}


def load_probe():
    spec = importlib.util.spec_from_file_location("torch_psiformer_pole_probe", PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


probe = load_probe()


@pytest.fixture(scope="module")
def values():
    """The walkers, the port's float32 and float64 values, and the JAX package's
    float64 values, as numpy."""
    cfg, model, stored = probe.prod_r4()
    data = probe.pole_walkers(stored)
    f32, f64 = probe.compare(model, cfg.system, torch.from_numpy(data))
    raw = yaml.safe_load((probe.ARTIFACT / "config.yml").read_text())
    with np.load(probe.ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        params = f["params"].tolist()
    with jax.enable_x64():
        jcfg = jax_config.Config.from_dict(raw)
        jmodel = jax_make_network(jcfg.system, jcfg.network)
        params = jax.tree.map(lambda v: np.asarray(v, np.float64), params)
        el, obs = jax.jit(jax_local_energy(jmodel, jcfg.system))(params, data.astype(np.float64))
        symmetric = {k: np.asarray(v).real for k, v in {"energy": el, **obs}.items()}
    return data, f32, f64, symmetric


@pytest.mark.parametrize("walker", range(len(probe.POLE_THETA)),
                         ids=[f"theta{i}" for i in range(len(probe.POLE_THETA))])
def test_float32_pole_walker_within_gate(values, walker):
    data, f32, f64, _ = values
    assert data[walker, 0, 0] == np.float32(probe.POLE_THETA[walker])
    bad = [b for b in probe.gate_failures(f32, f64) if b.split(":")[0].endswith(f"[{walker}]")]
    assert not bad, bad
    for key in probe.KEYS:
        assert np.isfinite(f32[key][walker]) and np.isfinite(f64[key][walker]), key


@pytest.mark.parametrize("key", probe.KEYS)
def test_float64_truth_is_the_symmetric_gauge_value(values, key):
    data, _, f64, symmetric = values
    theta = data[:, 0, 0].astype(np.float64)
    exact_enough = np.minimum(theta, np.pi - theta) >= 1e-2 - 1e-7
    n_pole = len(probe.POLE_THETA)
    assert exact_enough.sum() == 3 + (len(data) - n_pole)
    np.testing.assert_allclose(f64[key][exact_enough], symmetric[key][exact_enough], rtol=0,
                               atol=SYMMETRIC_TOL[key], err_msg=key)


def test_probe_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        probe.main([])
