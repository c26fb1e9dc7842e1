"""The port's observable estimators against the JAX package and physics oracles.

At N=3, 2Q=6 with a one-layer Psiformer whose weights are carried across by
``weights.load_flax``, on the same numpy-seeded walkers:

* ``density_histogram`` gives JAX's counts exactly, edge cases at theta = 0,
  pi and just outside the range included (held against ``jnp.histogram``);
* ``pair_histogram`` and the structure factor's Legendre means agree within
  1e-5 of the largest entry (float32, summation order only);
* the 1-RDM integrand with the same insertion points, and the Laughlin and ED
  importance ratios, agree within 1e-4 of the largest entry (a float32
  network; the port evaluates the ED state in complex128, JAX in complex64);
* each deterministic estimator's digest after 3 fixed steps agrees with JAX's
  (the same tolerances).

Then the physics oracles of ``tests/test_observables.py`` and
``tests/test_edstate.py:107-152`` through the port's ``evaluate_observable``
on the CPU: the Laughlin overlap with itself (1e-4), the 1-RDM's trace N, the
density's mass, the pair-correlation hole, S_L against the exact ED
multipoles, the ED overlap of the ED state with itself and its sector
awareness.
"""

from __future__ import annotations

import dataclasses
import math

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp
from torch import nn

from deephall_tpu import config as jax_config
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.networks.edstate import make_ed_network as jax_make_ed_network
from deephall_tpu.observables import estimators as jax_est
from deephall_tpu_torch import config
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.networks.edstate import make_ed_network
from deephall_tpu_torch.observables import ed, estimators, evaluate_observable
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)

RAW = {
    "system": {"nspins": [3, 0], "flux": 6},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 1, "heads_dim": 8,
                              "determinants": 1}},
}
BATCH, NELEC = 64, 3


def walkers(seed: int, batch: int = BATCH, nelec: int = NELEC) -> np.ndarray:
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def close(got, want, rtol: float) -> None:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rtol * np.abs(want).max(), np.abs(got - want).max()


@pytest.fixture(scope="module")
def psiformer():
    """``(jax cfg, jax model.apply, params, port cfg, port model)`` with the same weights."""
    jcfg = jax_config.Config.from_dict(RAW)
    cfg = config.Config.from_dict(RAW)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(3),
                                                           jnp.zeros((NELEC, 2))))
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    model.requires_grad_(False)
    return jcfg, jax.jit(jmodel.apply), params, cfg, model


def test_histogram_edges_are_jax_edges():
    for bins in (50, 200):
        want = jnp.histogram_bin_edges(jnp.zeros(1, jnp.float32), bins, range=(0.0, float(jnp.pi)))
        np.testing.assert_array_equal(estimators.histogram_edges(bins), np.asarray(want))


def test_density_histogram_identical_counts():
    data = walkers(0, batch=512)
    got = estimators.density_histogram(torch.from_numpy(data), 50)
    want = jax_est.density_histogram(jnp.asarray(data), 50)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.sum().item() == data.shape[0] * NELEC


@pytest.mark.parametrize("bins", [50, 200])
def test_histogram_edge_cases(bins):
    """theta = 0 and pi in the end bins, values just outside dropped, values on
    interior edges in the bin above, as ``jnp.histogram``."""
    pi = np.float32(np.pi)
    edges = estimators.histogram_edges(bins)
    x = np.concatenate([
        # (The smallest float32 below 0 is a denormal, which XLA flushes to 0.)
        [0.0, pi, np.nextafter(pi, np.float32(4)), -(2.0**-20), -0.5, 4.0,
         np.nextafter(pi, np.float32(0))],
        edges[1:-1], np.nextafter(edges[1:-1], np.float32(0)),
    ]).astype(np.float32)
    weights = np.random.default_rng(1).uniform(0.5, 2.0, x.shape).astype(np.float32)
    for w in (None, weights):
        got = estimators.angle_histogram(torch.from_numpy(x), bins,
                                         None if w is None else torch.from_numpy(w))
        want, _ = jnp.histogram(jnp.asarray(x), bins, range=(0.0, float(jnp.pi)),
                                weights=None if w is None else jnp.asarray(w))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # The four values outside [0, pi] are dropped.
    assert got.sum().item() == pytest.approx(weights.sum() - weights[2:6].sum(), rel=1e-6)


def test_pair_histogram_and_legendre_means():
    data = walkers(2)
    got = estimators.pair_histogram(torch.from_numpy(data), 200)
    close(got.numpy(), jax_est.pair_histogram(jnp.asarray(data), 200), 1e-5)
    jcfg = jax_config.Config.from_dict(RAW)
    jax_sf = jax_est.make_structure_factor(jcfg, None, lmax=8)
    want = jax_sf.evaluate(None, None, jnp.asarray(data), jax_sf.init(1))["p_l"]
    close(estimators.pair_legendre_means(torch.from_numpy(data), 8).numpy(), want, 1e-5)


def test_insertion_points_on_the_sphere():
    gen = torch.Generator().manual_seed(0)
    pts = estimators.sample_insertion_points(gen, (4096,))
    assert pts.shape == (4096, 2)
    assert 0 <= pts[:, 0].min() and pts[:, 0].max() <= math.pi
    assert -math.pi <= pts[:, 1].min() and pts[:, 1].max() <= math.pi
    # Uniform on the sphere: cos(theta) has mean 0 and variance 1/3.
    cos = torch.cos(pts[:, 0].double())
    assert abs(cos.mean().item()) < 0.05 and abs(cos.var().item() - 1 / 3) < 0.03


def test_rdm_product_matches_jax(psiformer):
    jcfg, japply, params, cfg, model = psiformer
    data = walkers(4, batch=16)
    rng = np.random.default_rng(5)
    r_prime = np.stack([np.arccos(rng.uniform(-1, 1, 16)), rng.uniform(-np.pi, np.pi, 16)],
                       axis=-1).astype(np.float32)[:, None, :]
    want = jax.jit(jax_est.make_rdm_product(jcfg, japply))(
        params, jnp.asarray(data), jnp.asarray(r_prime))
    with torch.no_grad():
        got = estimators.make_rdm_product(cfg, model)(
            torch.from_numpy(data), torch.from_numpy(r_prime))
    assert got.shape == (16, 7, 7)
    close(got.numpy(), np.asarray(want), 1e-4)


def test_target_ratios_match_jax(psiformer):
    """The Laughlin and ED ratios; JAX's ED state is evaluated in float64 here,
    as the port's is (in complex64 it loses up to 3e-3 in log phi at these
    walkers), and handed to JAX's ``make_target_ratios``."""
    jcfg, japply, params, cfg, model = psiformer
    data = walkers(6)
    with jax.enable_x64(True):
        jax_ed, _ = jax_make_ed_network(jax_config.System(flux=6, nspins=(3, 0)))
        log_phi = np.asarray(jax_ed(None, jnp.asarray(data, dtype=jnp.float64)))
    ed_network, _ = make_ed_network(cfg.system)
    pairs = {
        "laughlin": (jax_est.make_overlap_ratios(jcfg, japply),
                     estimators.make_overlap_ratios(cfg, model)),
        "ed": (jax_est.make_target_ratios(japply, lambda d: jnp.asarray(log_phi)),
               estimators.make_target_ratios(model, lambda d: ed_network(d.double()))),
    }
    for name, (jax_ratios, port_ratios) in pairs.items():
        want = jax_ratios(params, jnp.asarray(data))
        with torch.no_grad():
            got = port_ratios(torch.from_numpy(data))
        for g, w in zip(got, want):
            close(g.numpy(), np.asarray(w), 1e-4)
        assert got[0].dtype == (torch.complex128 if name == "ed" else torch.complex64)


@pytest.mark.parametrize("name,kwargs,rtol", [
    ("density", {}, 0.0), ("pair_corr", {}, 1e-5), ("structure_factor", {}, 1e-5),
    ("overlap", {}, 1e-4), ("ed_overlap", {}, 1e-4), ("density", {"bins": 20}, 0.0),
])
def test_digest_after_three_steps_matches_jax(psiformer, name, kwargs, rtol):
    jcfg, japply, params, cfg, model = psiformer
    jax_estimator = jax_est.ESTIMATORS[name](jcfg, japply, **kwargs)
    port = estimators.ESTIMATORS[name](cfg, model, **kwargs)
    jstate, state = jax_estimator.init(3), port.init(3)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for step in range(3):
            data = walkers(10 + step)
            jstate = jax_estimator.evaluate(params, None, jnp.asarray(data), jstate)
            state = port.evaluate(gen, torch.from_numpy(data), state)
    want, got = jax_estimator.digest(jstate, 3), port.digest(state, 3)
    assert set(got) == set(want)
    for key in want:
        if rtol == 0.0:
            np.testing.assert_array_equal(got[key], want[key])
        else:
            close(got[key], want[key], rtol)


def test_one_rdm_digest_shapes(psiformer):
    _, _, _, cfg, model = psiformer
    est = estimators.make_one_rdm(cfg, model)
    state = est.init(1)
    with torch.no_grad():
        state = est.evaluate(torch.Generator().manual_seed(0), torch.from_numpy(walkers(7)), state)
    out = est.digest(state, 1)
    assert out["one_rdm"].shape == (7, 7) and out["one_rdm"].dtype == np.complex128
    np.testing.assert_array_equal(out["diagonal"], np.diagonal(out["one_rdm"]))
    assert np.isfinite(out["one_rdm"]).all() and out["trace"] == np.trace(out["one_rdm"])


def test_masked_mean_is_nanmean():
    rng = np.random.default_rng(8)
    x = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(np.complex64)
    x[3] = complex(np.nan, 1.0)
    x[7] = complex(1.0, np.nan)
    got = estimators._masked_mean(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnp.nanmean(jnp.asarray(x))), rtol=1e-6)
    y = np.abs(x)
    np.testing.assert_allclose(estimators._masked_mean(torch.from_numpy(y)).numpy(),
                               np.asarray(jnp.nanmean(jnp.asarray(y))), rtol=1e-6)


# --------------------------------------------------------------------------- #
# Physics oracles through the port's evaluate_observable (CPU)
# --------------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def laughlin_run():
    cfg = config.Config.from_dict({"seed": 7, "batch_size": BATCH,
                                   "system": {"nspins": [3, 0], "flux": 6},
                                   "network": {"type": "laughlin"}})
    model = make_network(cfg.system, cfg.network)
    return cfg, model, {}, walkers(7), 0.3


def run(laughlin_run, name, steps, **kwargs):
    cfg, model, params, data, width = laughlin_run
    return evaluate_observable(cfg, model, params, data, width, name, steps=steps,
                               device="cpu", **kwargs)


def test_overlap_identity(laughlin_run):
    np.testing.assert_allclose(run(laughlin_run, "overlap", 3)["overlap"], 1.0, atol=1e-4)


def test_one_rdm_trace(laughlin_run):
    results = run(laughlin_run, "one_rdm", 30)
    assert abs(results["trace"].real - NELEC) < 0.5
    assert results["one_rdm"].shape == (7, 7)


def test_density_mass(laughlin_run):
    assert run(laughlin_run, "density", 4)["map"].sum() == 4 * BATCH * NELEC


def test_pair_corr_hole(laughlin_run):
    pair_corr = run(laughlin_run, "pair_corr", 3)["pair_corr"]
    assert pair_corr.shape == (200,) and np.all(np.isfinite(pair_corr))
    assert pair_corr[:5].sum() < pair_corr[100:105].sum()


def test_structure_factor_matches_exact(laughlin_run):
    """At N=3, 2Q=6 the ED ground state is the Laughlin state: its measured S_L
    equals the exact multipoles (statistical, as tests/test_edstate.py)."""
    cfg, model, params, data, width = laughlin_run
    result = ed.ed_block(3, 6, two_lz=0)
    measured = evaluate_observable(cfg, model, params, walkers(9, batch=512), width,
                                   "structure_factor", steps=20, seed=1, device="cpu",
                                   estimator_kwargs={"lmax": 4})["structure_factor"]
    np.testing.assert_allclose(measured[0], 3.0, atol=1e-6)
    np.testing.assert_allclose(measured, ed.structure_factor(result, 6, lmax=4), atol=0.06)


class Wavefunction(nn.Module):
    """A parameter-free ``data -> log psi`` callable as a module."""

    def __init__(self, logpsi):
        super().__init__()
        self.logpsi = logpsi

    def forward(self, data: torch.Tensor) -> torch.Tensor:
        return self.logpsi(data)


def test_ed_overlap_of_the_laughlin_state_is_one(laughlin_run):
    np.testing.assert_allclose(run(laughlin_run, "ed_overlap", 2)["overlap"], 1.0, atol=1e-5)


def test_ed_overlap_is_sector_aware():
    """The exact ground state of the 2Lz=2 block of N=3, 2Q=4 has overlap 1 with
    the target of a config that carries the Lz penalty at 1, and ~0 with the
    Lz=0 block's."""
    system = config.System(flux=4, nspins=(3, 0))
    network, _ = make_ed_network(system, two_lz=2)

    def overlap(cfg_system):
        cfg = config.Config()
        cfg.system = cfg_system
        return float(evaluate_observable(cfg, Wavefunction(network), {}, walkers(11), 0.3,
                                         "ed_overlap", steps=1, device="cpu")["overlap"])

    sector = dataclasses.replace(system, lz_penalty=1.0, lz_center=1.0)
    np.testing.assert_allclose(overlap(sector), 1.0, atol=1e-6)
    assert overlap(system) < 0.2
