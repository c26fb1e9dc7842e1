"""The port's full-Hessian local energy against exact oracles and the JAX package.

``hamiltonian.local_energy`` / ``make_local_kinetic_energy`` take the gradient
and the Hessian of a per-walker ``log psi`` by ``torch.func`` (``vmap`` of
``jacfwd`` over ``jacrev``).  The oracles of ``tests/test_hamiltonian.py``:
free electrons in Y_1m orbitals give KE = 3 and L^2 = 0, exact lowest-Landau-
level determinants KE = N/2 and their L^2, both within 1e-3 in float32 as
there and within 1e-3 of the JAX package's values on the same walkers.  The
Psiformer's Hessian path against the port's own jet and against the JAX
package's ``local_energy`` on ``tests/test_fwdlap.py``'s three cases: in
float64 the two routes of the port agree to 1e-9 of each observable's largest
value, so they share no mistake; in float32 the port's Hessian path lies within
``test_fwdlap.py``'s 2e-3 of JAX's.
"""

from __future__ import annotations

import copy
import math

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import hamiltonian as jax_hamiltonian
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config, hamiltonian, loss, optimizers
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops.slogdet import slogdet
from deephall_tpu_torch.weights import init_params, load_flax

torch.set_num_threads(2)

OBSERVABLES = ("kinetic", "potential", "angular_momentum_z", "angular_momentum_z_square",
               "angular_momentum_square")


def walkers(batch: int, nelec: int, seed: int, margin: float = 0.0) -> np.ndarray:
    """``[batch, nelec, 2]`` float32; theta kept ``margin`` away from the poles."""
    rng = np.random.default_rng(seed)
    if margin:
        theta = rng.uniform(margin, np.pi - margin, (batch, nelec))
    else:
        theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def log_det(orbitals, slogdet_fn, log, to_complex):
    sign, logdet = slogdet_fn(orbitals)
    return logdet + log(to_complex(sign))


def free_electron(xp, slogdet_fn, log, to_complex):
    """Determinant of the l=1 spherical harmonics Y_1m."""

    def log_psi(data):
        theta, phi = data[..., 0], data[..., 1]
        orb = xp.stack([xp.sin(theta) * xp.cos(phi), xp.cos(theta), xp.sin(theta) * xp.sin(phi)],
                       -1)
        return log_det(orb, slogdet_fn, log, to_complex)

    return log_psi


def lll(nelec, Q, xp, slogdet_fn, log, to_complex):
    """Exact LLL determinant at monopole strength Q."""

    def log_psi(data):
        theta, phi = data[..., 0], data[..., 1]
        u = xp.cos(theta / 2) * xp.exp(1j * phi / 2)
        v = xp.sin(theta / 2) * xp.exp(-1j * phi / 2)
        orb = xp.stack([u**m * v ** (2 * Q - m) for m in range(nelec)], -1)
        return log_det(orb, slogdet_fn, log, to_complex)

    return log_psi


TORCH = (torch, slogdet, torch.log, lambda s: s.to(torch.complex128 if s.dtype == torch.float64
                                                     else torch.complex64))
JAX = (jnp, jnp.linalg.slogdet, jnp.log, lambda s: s.astype(jnp.complex64))


def check(make, Q, r, batch, nelec, ke_want, l2_want):
    data = walkers(batch, nelec, seed=1898)
    ke, obs = torch.func.vmap(hamiltonian.make_local_kinetic_energy(make(*TORCH), Q, r))(
        torch.from_numpy(data))
    jax_ke, jax_obs = jax.jit(jax.vmap(
        jax_hamiltonian.make_local_kinetic_energy(lambda p, x: make(*JAX)(x), Q, r),
        in_axes=(None, 0)))(None, jnp.asarray(data))
    l2 = obs["angular_momentum_square"].numpy()
    np.testing.assert_allclose(ke.real.numpy(), ke_want, atol=1e-3)
    np.testing.assert_allclose(l2, l2_want, atol=1e-3)
    np.testing.assert_allclose(ke.numpy(), np.asarray(jax_ke), atol=1e-3)
    np.testing.assert_allclose(l2, np.asarray(jax_obs["angular_momentum_square"]), atol=1e-3)
    for key in ("angular_momentum_z", "angular_momentum_z_square"):
        np.testing.assert_allclose(obs[key].numpy(), np.asarray(jax_obs[key]), atol=1e-3)


def test_free_electron():
    check(lambda *ops: free_electron(*ops), 0, 1, 2, 3, 3.0, 0.0)


@pytest.mark.parametrize("nelec,Q,L_square", [(1, 1, 2), (3, 1, 0), (9, 4, 0)])
def test_kinetic_and_angular_momentum(nelec, Q, L_square):
    check(lambda *ops: lll(nelec, Q, *ops), Q, math.sqrt(Q), 2, nelec, nelec / 2, L_square)


def test_potentials():
    """Coulomb of two antipodal electrons = 1/(2r); harmonic closed form."""
    data = torch.tensor([[math.pi / 2, 0.0], [math.pi / 2, math.pi]])  # antipodal on equator
    pe = hamiltonian.make_potential(config.InteractionType.coulomb, Q=1, r=2.0)
    assert torch.allclose(pe(data), torch.tensor(1 / (2 * 2.0)))
    pe_h = hamiltonian.make_potential(config.InteractionType.harmonic, Q=1.0, r=1.0)
    # cos(theta_12) = -1 -> 1 + 2*(-1) = -1
    assert torch.allclose(pe_h(data), torch.tensor(-1.0))


CASES = [
    # (flux, nspins, orbital, ndets), tests/test_fwdlap.py
    (4, (3, 0), "full", 1),
    (4, (2, 1), "full", 2),
    (6, (3, 0), "sparse", 2),
]


@pytest.mark.parametrize("flux,nspins,orbital,ndets", CASES)
def test_psiformer_hessian_path_matches_jet_and_jax(flux, nspins, orbital, ndets):
    raw = {"system": {"flux": flux, "nspins": list(nspins)},
           "network": {"orbital": orbital, "psiformer": {
               "num_heads": 2, "heads_dim": 8, "num_layers": 2, "determinants": ndets}}}
    jcfg, cfg = jax_config.Config.from_dict(raw), config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    nelec = sum(nspins)
    data = walkers(4, nelec, seed=flux + ndets, margin=0.3)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(2), data[0]))
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    model.requires_grad_(False)

    def hessian_path(net, x):
        return torch.func.vmap(hamiltonian.local_energy(lambda w: net(w[None])[0], cfg.system))(x)

    # float64: the Hessian path against the jet, two routes that share no rule.
    net64, x64 = copy.deepcopy(model).double(), torch.from_numpy(data).double()
    el, obs = hessian_path(net64, x64)
    with torch.no_grad():
        jet_el, jet_obs = hamiltonian.forward_laplacian_local_energy(net64, cfg.system)(x64)
    for key, got, want in (("energy", el, jet_el), *((k, obs[k], jet_obs[k]) for k in OBSERVABLES)):
        scale = want.abs().max().item()
        assert (got - want).abs().max().item() <= 1e-9 * max(scale, 1.0), key

    # float32 against the JAX package's local_energy.
    el32, obs32 = hessian_path(model, torch.from_numpy(data))
    want_el, want = jax.jit(jax.vmap(jax_hamiltonian.local_energy(jmodel.apply, jcfg.system),
                                     in_axes=(None, 0)))(params, jnp.asarray(data))
    np.testing.assert_allclose(el32.numpy(), np.asarray(want_el), rtol=2e-3, atol=2e-3)
    for key in OBSERVABLES:
        np.testing.assert_allclose(obs32[key].numpy(), np.asarray(want[key]), rtol=2e-3,
                                   atol=2e-3, err_msg=key)


def test_loss_dispatch():
    """The jet for the Psiformer, the Hessian path in float64 for every other
    network; a network without parameters gets an empty gradient under Adam
    and a ``ValueError`` under KFAC, where the JAX package fails too."""
    laughlin = config.Config.from_dict(
        {"system": {"nspins": [3, 0], "flux": 6}, "network": {"type": "laughlin"}})
    model = make_network(laughlin.system, laughlin.network)
    data = torch.from_numpy(walkers(8, 3, seed=5))
    el, obs = loss.batched_local_energy(model, laughlin.system)(data)
    want_el, want = torch.func.vmap(hamiltonian.local_energy(model, laughlin.system))(
        data.double())
    torch.testing.assert_close(el, want_el)
    torch.testing.assert_close(obs, want)
    np.testing.assert_allclose(obs["kinetic"].real.numpy(), 1.5, atol=1e-3)
    stats, grads = loss.make_loss_fn(model, laughlin.system, loss.LossMode.ENERGY_GRAD)(data)
    assert grads == {} and torch.isfinite(stats["energy"].real)
    laughlin.optim.optimizer = "kfac"
    with pytest.raises(ValueError, match="laughlin"):
        optimizers.make_optimizer_step(laughlin, model)

    psiformer = config.Config.from_dict({"system": {"nspins": [3, 0], "flux": 4}, "network": {
        "psiformer": {"num_heads": 1, "heads_dim": 4, "num_layers": 1}}})
    model = make_network(psiformer.system, psiformer.network)
    init_params(model, torch.Generator().manual_seed(0))
    x = torch.from_numpy(walkers(4, 3, seed=6, margin=0.3))
    with torch.no_grad():
        got_el, got = loss.batched_local_energy(model, psiformer.system)(x)
        jet_el, jet = hamiltonian.forward_laplacian_local_energy(model, psiformer.system)(x)
    torch.testing.assert_close(got_el, jet_el)
    torch.testing.assert_close(got, jet)
