"""The port's Psiformer log psi against the JAX package's ``model.apply``."""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.networks import blocks as jax_blocks
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts/prod_r4"


def artifact():
    with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        return f["params"].tolist(), np.asarray(f["data"][:8])


def models(raw):
    jcfg = jax_config.Config.from_dict(raw)
    cfg = config.Config.from_dict(raw)
    return jax_make_network(jcfg.system, jcfg.network), make_network(cfg.system, cfg.network)


def random_walkers(seed, batch, nelec):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def test_artifact_logpsi_matches():
    # float32 forward of the same weights: summation order only, rtol 1e-5.
    params, data = artifact()
    jmodel, model = models(yaml.safe_load((ARTIFACT / "config.yml").read_text()))
    load_flax(model, params)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(data)))
    with torch.no_grad():
        got = model(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("orbital,ndets,nspins", [("sparse", 2, (3, 2)), ("full", 2, (2, 2))])
def test_random_init_logpsi_matches(orbital, ndets, nspins):
    # Small random network (1 layer, 2 heads x 8) with spin-down electrons and
    # two determinants; float32, rtol 1e-5 of the largest |log psi|.
    raw = {
        "system": {"nspins": list(nspins), "flux": 4},
        "network": {"orbital": orbital, "psiformer": {
            "num_layers": 1, "num_heads": 2, "heads_dim": 8, "determinants": ndets}},
    }
    jmodel, model = models(raw)
    nelec = sum(nspins)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(7), jnp.zeros((nelec, 2))))
    load_flax(model, params)
    data = random_walkers(3, 16, nelec)
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(data)))
    with torch.no_grad():
        got = model(torch.from_numpy(data)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.max(np.abs(want)))


def test_bf16_tower_matches():
    # The sweep's bfloat16 tower rounds at other places in the two frameworks
    # (8-bit mantissa: ~4e-3 relative on |log psi| ~ 10), so atol 0.05; the
    # float32 result must differ, which shows the tower really ran in bf16.
    params, data = artifact()
    jmodel, model = models(yaml.safe_load((ARTIFACT / "config.yml").read_text()))
    load_flax(model, params)
    with jax_blocks.tower_dtype(jnp.bfloat16):
        want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(data)))
    with torch.no_grad():
        got = model(torch.from_numpy(data), torch.bfloat16).numpy()
        full = model(torch.from_numpy(data)).numpy()
    assert got.dtype == np.complex64
    np.testing.assert_allclose(got, want, atol=0.05)
    assert np.max(np.abs(got - full)) > 1e-4


def test_unported_networks_raise():
    # Every network of the config is ported now: the Laughlin dispatch (with
    # the excitation's Lz from system.lz_center) gives the JAX package's log
    # psi, within 1e-5 of the largest |Re| and its phase mod 2 pi.
    raw = {"system": {"nspins": [4, 0], "flux": 10, "lz_center": 1.0},
           "network": {"type": "laughlin"}}
    jmodel, model = models(raw)
    data = random_walkers(7, 5, 4)
    want = np.asarray(jax.jit(jax.vmap(lambda x: jmodel.apply({}, x)))(jnp.asarray(data)))
    with torch.no_grad():
        got = model(torch.from_numpy(data)).numpy()
    assert model.excitation_lz == 1.0 and not list(model.parameters())
    assert np.abs(got.real - want.real).max() < 1e-5 * np.abs(want.real).max()
    np.testing.assert_allclose(np.exp(1j * (got.imag - want.imag)), 1.0, atol=1e-5)
