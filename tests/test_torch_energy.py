"""Per-walker local energy and observables of the port against the JAX package.

Both evaluate the forward-Laplacian jet in float32, but sum the second
derivatives in another order (and the port seeds the input functions with
closed-form derivatives where JAX nests ``jvp``), hence rtol 1e-4 / atol 1e-4.
L^2 is a sum of terms of size ``Mbar_a^2 ~ 10^2`` that cancel to O(1), so its
float32 rounding is larger: both packages lie within 4e-4 of a float64
evaluation of the port on these walkers, and L^2 is held at atol 1e-3.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import hamiltonian as jax_hamiltonian
from deephall_tpu.hamiltonian import forward_laplacian_local_energy as jax_local_energy
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config
from deephall_tpu_torch import hamiltonian
from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts/prod_r4"
OBSERVABLES = ("angular_momentum_z", "angular_momentum_z_square", "kinetic", "potential")


def jax_energies(raw, params, data):
    """The JAX package's ``(E_L, observables)`` of ``data``."""
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    return jax.jit(jax_local_energy(jmodel, jcfg.system))(params, jnp.asarray(data))


def compare(raw, params, data, atol=1e-4, l2_atol=1e-3, want=None):
    """The port's local energy against the JAX package's, or against ``want``,
    its result on the same inputs."""
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    want_el, want = want if want is not None else jax_energies(raw, params, data)
    with torch.no_grad():
        got_el, got = forward_laplacian_local_energy(model, cfg.system)(torch.from_numpy(data))
    np.testing.assert_allclose(got_el.numpy(), np.asarray(want_el), rtol=1e-4, atol=atol)
    for key in OBSERVABLES:
        np.testing.assert_allclose(
            got[key].numpy(), np.asarray(want[key]), rtol=1e-4, atol=atol, err_msg=key
        )
    l2, want_l2 = got["angular_momentum_square"].numpy(), np.asarray(want["angular_momentum_square"])
    if cfg.system.compute_l2:
        np.testing.assert_allclose(l2, want_l2, rtol=1e-4, atol=l2_atol)
    else:
        assert np.isnan(l2).all() and np.isnan(want_l2).all()


@pytest.mark.parametrize("compute_l2", [True, False])
def test_artifact_walkers(compute_l2):
    raw = yaml.safe_load((ARTIFACT / "config.yml").read_text())
    raw["system"]["compute_l2"] = compute_l2
    with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        params, data = f["params"].tolist(), np.asarray(f["data"][:8])
    compare(raw, params, data)


def test_random_sparse_two_determinants():
    # Spin-down electrons, sparse orbitals, two determinants.
    # A randomly initialised network is far from an eigenstate (|E_L| up to 25,
    # L^2 up to 78 on these walkers) and its orbital matrices are worse
    # conditioned: both packages lie within 6e-4 of a float64 evaluation of
    # the port here, so atol 2e-3; a wrong rule would be off by O(1).
    raw = {
        "system": {"nspins": [3, 1], "flux": 5, "compute_l2": True},
        "network": {"orbital": "sparse", "psiformer": {
            "num_layers": 1, "num_heads": 2, "heads_dim": 8, "determinants": 2}},
    }
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(2), jnp.zeros((4, 2)))
    )
    rng = np.random.default_rng(4)
    data = np.stack([np.arccos(rng.uniform(-0.9, 0.9, (6, 4))),
                     rng.uniform(-np.pi, np.pi, (6, 4))], -1).astype(np.float32)
    compare(raw, params, data, atol=2e-3, l2_atol=2e-3)


PUBLISHED = {
    "system": {"nspins": [4, 0], "flux": 9, "compute_l2": True},
    "network": {"psiformer": {"num_layers": 4, "num_heads": 2, "heads_dim": 8, "determinants": 16}},
}


@pytest.fixture(scope="module")
def published_depth():
    """The published Psiformer's depth and determinants (4 layers, 16
    determinants, full orbitals) at small widths, N=4, 2Q=9, on flax's
    initial weights and 8 walkers, with the JAX package's energies."""
    jcfg = jax_config.Config.from_dict(PUBLISHED)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3), jnp.zeros((4, 2)))
    )
    rng = np.random.default_rng(5)
    data = np.stack([np.arccos(rng.uniform(-0.9, 0.9, (8, 4))),
                     rng.uniform(-np.pi, np.pi, (8, 4))], -1).astype(np.float32)
    return params, data, jax_energies(PUBLISHED, params, data)


def test_published_depth_and_determinants(published_depth):
    """The port's orbital head, envelope contraction and determinants at the
    published depth and determinants against JAX.

    Both packages lie within 1.3e-4 of a float64 evaluation of the port on
    these walkers (L_z^2, of size 60), inside the module's rtol 1e-4."""
    params, data, want = published_depth
    compare(PUBLISHED, params, data, want=want)


@pytest.mark.parametrize("interaction", ["coulomb", "harmonic"])
def test_potentials_match(interaction):
    rng = np.random.default_rng(9)
    data = np.stack([np.arccos(rng.uniform(-1, 1, (16, 5))),
                     rng.uniform(-np.pi, np.pi, (16, 5))], -1).astype(np.float32)
    kind = config.InteractionType(interaction)
    want = jax_hamiltonian.make_potential(
        jax_config.InteractionType(interaction), 3.5, jnp.sqrt(3.5)
    )(jnp.asarray(data))
    got = hamiltonian.make_potential(kind, 3.5, float(np.sqrt(3.5)))(torch.from_numpy(data))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
