"""The port's analytic Laughlin / composite-fermion states against the JAX package.

``log psi`` of every branch (ground, quasihole, quasiparticle, Jain with the
hand-derived two-level projection and with the general n-level construction)
within 1e-5 of the largest |Re log psi|, phases compared mod 2 pi, in float32
on numpy-seeded walkers.  The exact oracles of ``tests/test_features.py``
(KE = N/2 and L^2 = 0 for filled shells) through the port's full-Hessian local
energy in float64, within 1e-6.  The N=3, 2Q=6 CLI anchor of
``tests/test_cli.py``, and Laughlin checkpoints both ways.
"""

from __future__ import annotations

import csv
import math

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.log import CheckpointState as JaxCheckpointState
from deephall_tpu.log import LogManager as JaxLogManager
from deephall_tpu.networks.laughlin import Laughlin as JaxLaughlin
from deephall_tpu.observables.runner import load_run as jax_load_run
from deephall_tpu_torch import config, train
from deephall_tpu_torch.hamiltonian import make_local_kinetic_energy
from deephall_tpu_torch.networks.laughlin import Laughlin, lambda_level_terms

torch.set_num_threads(2)


def walkers(batch: int, nelec: int, seed: int = 0) -> np.ndarray:
    """Uniform on the sphere, ``[batch, nelec, 2]`` float32."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def assert_same_log_psi(got: np.ndarray, want: np.ndarray, rtol: float) -> None:
    scale = np.abs(want.real).max()
    assert np.abs(got.real - want.real).max() <= rtol * scale
    np.testing.assert_allclose(np.exp(1j * (got.imag - want.imag)), 1.0, atol=rtol)


# (nelec, flux, excitation_lz, branch)
BRANCHES = [
    (3, 6, 0, "full_orbitals"),  # ground state, nu = 1/3
    (6, 15, 0, "full_orbitals"),
    (4, 10, 0, "full_orbitals"),  # quasihole (N = 2 Q1)
    (4, 10, 1, "full_orbitals"),
    (4, 8, 0, "quasiparticle_orbitals"),  # N = 2 Q1 + 2
    (4, 8, -2, "quasiparticle_orbitals"),
    (4, 6, 0, "jain_two_level_orbitals"),  # nu = 2/5
    (8, 16, 0, "jain_two_level_orbitals"),
    (12, 23, 0, "jain_orbitals"),  # nu = 3/7, three Lambda levels
]


@pytest.mark.parametrize("nelec,flux,lz,branch", BRANCHES)
def test_log_psi_matches_jax(nelec, flux, lz, branch):
    data = walkers(4, nelec, seed=nelec + flux)
    model = Laughlin((nelec, 0), flux, excitation_lz=lz)
    assert model.cf_orbitals.__name__ == branch
    assert not list(model.parameters())
    jmodel = JaxLaughlin(nspins=(nelec, 0), flux=flux, excitation_lz=lz)
    want = np.asarray(jax.jit(jax.vmap(lambda x: jmodel.apply({}, x)))(jnp.asarray(data)))
    with torch.no_grad():
        got = model(torch.from_numpy(data), torch.bfloat16).numpy()
    assert got.dtype == np.complex64
    assert_same_log_psi(got, want, 1e-5)


@pytest.mark.parametrize("lz,nelec,flux", [(3, 4, 10), (0.5, 4, 10), (-4, 4, 8)])
def test_unattainable_excitation_raises(lz, nelec, flux):
    with pytest.raises(ValueError, match="Impossible Lz"):
        Laughlin((nelec, 0), flux, excitation_lz=lz)


@pytest.mark.parametrize("nelec,flux,batch", [(4, 6, 3), (8, 16, 3), (12, 23, 2)])
def test_filled_shell_oracles(nelec, flux, batch):
    """Filled Lambda levels: rotationally invariant and in the lowest Landau
    level after projection, so KE = N/2 and L^2 = 0 at every walker."""
    data = walkers(batch, nelec, seed=1)
    model = Laughlin((nelec, 0), flux)
    Q = flux / 2
    ke_fn = make_local_kinetic_energy(model, Q, math.sqrt(Q))
    ke, obs = torch.func.vmap(ke_fn)(torch.from_numpy(data).double())
    np.testing.assert_allclose(ke.real.numpy(), nelec / 2, atol=1e-6)
    np.testing.assert_allclose(ke.imag.numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(obs["angular_momentum_square"].numpy(), 0.0, atol=1e-6)


class GeneralJain(Laughlin):
    """Laughlin with the Jain dispatch forced to the general Lambda-level path."""

    def __init__(self, nspins, flux, n_levels: int = 2):
        super().__init__(nspins, flux)
        self.use_general_jain(n_levels)


@pytest.mark.parametrize("nelec,flux", [(4, 6), (8, 16)])
def test_general_jain_matches_hand_derived_two_level(nelec, flux):
    """Columns may differ by constants, so log psi differs by one complex
    constant over the batch (``tests/test_features.py``, same tolerances)."""
    data = torch.from_numpy(walkers(6, nelec, seed=2))
    hand = Laughlin((nelec, 0), flux)
    general = GeneralJain((nelec, 0), flux)
    assert general.cf_orbitals.__name__ == "jain_orbitals"
    with torch.no_grad():
        diff = (general(data) - hand(data)).numpy()
    np.testing.assert_allclose(diff.real, diff.real[0], atol=1e-4)
    np.testing.assert_allclose(np.exp(1j * (diff.imag - diff.imag[0])), 1.0, atol=1e-4)


def test_lambda_level_terms_match_jax():
    from deephall_tpu.networks.laughlin import lambda_level_terms as jax_terms

    for two_q1, level in ((1, 0), (1, 2), (4, 1), (3, 2)):
        assert lambda_level_terms(two_q1, level) == jax_terms(two_q1, level)


def test_cli_anchor(tmp_path):
    # tests/test_cli.py through the port's CLI: N=3, 2Q=6, batch 3360, 100
    # iterations; E = 2.5867 exactly (tests/test_ed.py) and L^2 written as
    # 0.0000.  The burn-in is cut from 200 to 20 sweeps, to keep the test short.
    history = train.cli([
        "seed=42", "system.nspins=[3, 0]", "system.flux=6", "network.type=laughlin",
        "optim.iterations=100", "optim.optimizer=none", "mcmc.burn_in=20",
        f"log.save_path={tmp_path}", "--device", "cpu",
    ])
    assert len(history) == 100
    energy = np.mean([row["energy"].real for row in history])
    assert abs(energy - 2.5867) < 0.01, energy
    with open(tmp_path / "train_stats.csv") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 100
    assert "0.0000" in {row["L_square"] for row in rows}
    assert abs(np.mean([row["angular_momentum_square"] for row in history])) < 5e-5

    # The checkpoint reads back through the JAX package's load_run.
    cfg, jmodel, params, data, _ = jax_load_run(str(tmp_path / "ckpt_000099.npz"))
    assert cfg.network.type == jax_config.NetworkType.laughlin and data.shape == (3360, 3, 2)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(data[:8])))
    with torch.no_grad():
        got = Laughlin((3, 0), 6)(torch.from_numpy(np.asarray(data[:8]))).numpy()
    assert_same_log_psi(got, want, 1e-5)


def test_jax_checkpoint_runs_as_a_fixed_state(tmp_path):
    """A JAX Laughlin run directory (``params`` empty) is a port fixed state."""
    raw = {"system": {"nspins": [3, 0], "flux": 6}, "network": {"type": "laughlin"},
           "log": {"save_path": str(tmp_path / "laughlin")}}
    jcfg = jax_config.Config.from_dict(raw)
    JaxLogManager(jcfg).save_checkpoint(0, JaxCheckpointState({}, walkers(4, 3), None, 0.1))
    cfg = config.Config.from_dict({
        "system": {"nspins": [3, 0], "flux": 6,
                   "orthogonal_states": [str(tmp_path / "laughlin" / "ckpt_000000.npz")]}})
    (fixed,) = train.load_fixed_states(cfg, "cpu")
    data = walkers(5, 3, seed=4)
    jmodel = JaxLaughlin(nspins=(3, 0), flux=6)
    want = np.asarray(jax.vmap(lambda x: jmodel.apply({}, x))(jnp.asarray(data)))
    got = fixed(torch.from_numpy(data))
    assert not got.requires_grad
    assert_same_log_psi(got.numpy(), want, 1e-5)
