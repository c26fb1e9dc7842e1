"""The port's Metropolis-Hastings moves and width adaptation against the JAX package.

The two frameworks draw different numbers from a seed, so JAX's draws are
rebuilt here with the key splits of ``deephall_tpu/mcmc.py`` and handed to the
port.  Positions are compared as unit vectors, at atol 5e-4: the proposal's
angles come out of ``arccos``, whose slope diverges where its argument nears
+-1, and the azimuth is ``arccos(x / sin theta)``, so near a pole float32
rounding moves the azimuth by ~1e-4 / sin(theta).  Measured: 2e-6 after one
move, 1.3e-4 for one electron near a pole after chained moves.  The accept
decisions and acceptance rates must agree exactly.
"""

from __future__ import annotations

import jax
import numpy as np
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import mcmc as jax_mcmc
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.train import make_iteration_block
from deephall_tpu.types import CheckpointState as JaxState
from deephall_tpu_torch import config, mcmc, train
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)


def jax_draws(key, shape):
    """The normal, uniform and accept draws one ``mh_update`` makes from ``key``."""
    _, key_sample, key_cond = jax.random.split(key, 3)
    key_theta, key_phi = jax.random.split(key_sample)
    return (
        np.asarray(jax.random.normal(key_theta, shape)),
        np.asarray(jax.random.uniform(key_phi, shape)),
        np.asarray(jax.random.uniform(key_cond, shape[:-1])),
    )


def unit_vectors(x):
    x = np.asarray(x, np.float64)
    theta, phi = x[..., 0], x[..., 1]
    return np.stack([np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)], -1)


def test_mh_moves_match():
    raw = {"system": {"nspins": [3, 1], "flux": 4},
           "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 8}}}
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(1), jnp.zeros((4, 2))))
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)

    rng = np.random.default_rng(0)
    data = np.stack([np.arccos(rng.uniform(-1, 1, (64, 4))),
                     rng.uniform(-np.pi, np.pi, (64, 4))], -1).astype(np.float32)
    width = 0.3
    japply = jax.jit(jmodel.apply)
    jupdate = jax.jit(
        lambda p, x, k, lp, n: jax_mcmc.mh_update(p, jmodel.apply, x, k, lp, n, width)
    )
    key = jax.random.PRNGKey(42)
    jx, jlp, jacc = jnp.asarray(data), 2.0 * japply(params, jnp.asarray(data)).real, 0.0
    tx = torch.from_numpy(data.copy())
    with torch.no_grad():
        tlp = 2.0 * model(tx).real
        taccs = []
        for _ in range(3):
            normal, uniform, accept = (v.copy() for v in jax_draws(key, data.shape[:-1]))
            proposal = np.asarray(jax_mcmc.sph_sampling(jax.random.split(key, 3)[1], jx, width))
            got_proposal = mcmc.sph_sampling(
                tx, width, torch.from_numpy(normal), torch.from_numpy(uniform)
            )
            np.testing.assert_allclose(unit_vectors(got_proposal), unit_vectors(proposal), atol=5e-4)

            jx_new, key, jlp, jacc = jupdate(params, jx, key, jlp, jacc)
            tx_new, tlp, rate = mcmc.mh_update(
                model, tx, tlp, width, torch.from_numpy(normal),
                torch.from_numpy(uniform), torch.from_numpy(accept),
            )
            jmoved = np.any(np.asarray(jx_new) != np.asarray(jx), axis=(-2, -1))
            tmoved = np.any(tx_new.numpy() != tx.numpy(), axis=(-2, -1))
            np.testing.assert_array_equal(tmoved, jmoved)
            np.testing.assert_allclose(unit_vectors(tx_new), unit_vectors(jx_new), atol=5e-4)
            jx, tx = jx_new, tx_new
            taccs.append(float(rate))
    assert 0 < jacc < 3
    np.testing.assert_allclose(np.mean(taccs), float(jacc) / 3, rtol=1e-6)


def test_mcmc_step_runs_with_a_generator():
    def log_psi(x):
        return torch.complex(-torch.cos(x[..., 0]).sum(-1), torch.zeros(x.shape[:-2]))

    gen = torch.Generator().manual_seed(0)
    data = torch.full((32, 3, 2), 1.0)
    new, pmove = mcmc.make_mcmc_step(log_psi, steps=4)(data, 0.2, gen)
    assert new.shape == data.shape and 0 < float(pmove) <= 1
    again, pmove2 = mcmc.make_mcmc_step(log_psi, steps=4)(
        data, 0.2, torch.Generator().manual_seed(0)
    )
    torch.testing.assert_close(again, new)
    assert float(pmove2) == float(pmove)


def test_width_ring_matches_iteration_block():
    # The JAX package adapts the width inside its fused iteration block
    # (train.py:185-191); a stub sweep feeds it a fixed acceptance sequence.
    adapt, length = 5, 23
    seq = np.float32([0.6] * 16 + [0.3] * 4 + [0.52] * 3)
    cfg = jax_config.Config.from_dict({"mcmc": {"adapt_frequency": adapt}})
    table = jnp.asarray(seq)

    def sweep(params, data, key, width):
        del params, key, width
        return data + 1, table[data[0, 0, 0].astype(jnp.int32)]

    def step(state, key):
        del key
        return state, {"energy": state.data[0, 0, 0]}

    block = make_iteration_block(cfg, sweep, step)
    state = JaxState({}, jnp.zeros((1, 1, 2)), None, jnp.float32(0.1))
    state, _, jpmoves, jt, (_, jpmove) = block(
        state, jax.random.PRNGKey(0), jnp.zeros(adapt), jnp.int32(0), length
    )
    np.testing.assert_array_equal(np.asarray(jpmove), seq)

    # The port's block with the same stubs: the ring, the counter and the width
    # stay tensors, and the width is float32 throughout.
    ttable = torch.from_numpy(seq)

    def port_sweep(data, width):
        del width
        return data + 1, ttable[data[0, 0, 0].long()]

    def port_step(state, penalties):
        del penalties
        return state, {"energy": state.data[0, 0, 0]}

    port_block = train.make_iteration_block(config.Config.from_dict({"mcmc": {"adapt_frequency": adapt}}),
                                            port_sweep, port_step)
    pstate = train.CheckpointState(None, torch.zeros((1, 1, 2)), None, torch.tensor(0.1))
    pstate, pmoves, t, stats, pmove = port_block(
        pstate, torch.zeros(adapt), torch.tensor(0, dtype=torch.int32), length)
    np.testing.assert_array_equal(pmove.numpy(), seq)
    np.testing.assert_array_equal(stats["energy"].numpy(), np.arange(1, length + 1))
    assert int(t) == int(jt) == length
    np.testing.assert_array_equal(pmoves.numpy(), np.asarray(jpmoves))
    assert pstate.mcmc_width.dtype == torch.float32
    # XLA folds the division by 1.1 into a product with its reciprocal.
    np.testing.assert_allclose(pstate.mcmc_width.numpy(), np.asarray(state.mcmc_width), rtol=1e-6)
    np.testing.assert_allclose(pstate.mcmc_width.numpy(), 0.1 * 1.1**2, rtol=1e-6)
