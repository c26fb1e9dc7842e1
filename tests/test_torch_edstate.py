"""ED eigenstates as wavefunctions in the port, against exact identities and JAX.

``tests/test_edstate.py:45-105`` with the port's copy of ``observables/ed.py``
and its full-Hessian local energy: at N=3, 2Q=6 the ED ground state is the
Laughlin state (a constant log difference, 1e-5), and the evaluator gives the
JAX package's log psi (1e-10, both in float64); the kinetic local value is
N/2 and the L^2 local value the multiplet's eigenvalue at every walker (1e-8
in float64, 1e-4 in float32 as there); the mean local energy over
``|psi_ED|^2`` is the eigenvalue (0.05, statistical).  The copies of
``ed_block`` and ``ed_ground_lanczos`` equal the JAX package's to 1e-12.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.networks.edstate import make_ed_logpsi as jax_make_ed_logpsi
from deephall_tpu.networks.edstate import make_ed_network as jax_make_ed_network
from deephall_tpu.observables import ed as jax_ed
from deephall_tpu.observables import ed_native as jax_ed_native
from deephall_tpu_torch import config, hamiltonian, mcmc
from deephall_tpu_torch.networks.edstate import make_ed_logpsi, make_ed_network
from deephall_tpu_torch.networks.laughlin import Laughlin
from deephall_tpu_torch.observables import ed, ed_native

torch.set_num_threads(2)

SYSTEM = config.System(flux=6, nspins=(3, 0))


def walkers(batch: int, nelec: int, seed: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return torch.from_numpy(np.stack([theta, phi], axis=-1).astype(np.float32))


@pytest.fixture(scope="module")
def laughlin_block():
    network, result = make_ed_network(SYSTEM)
    return network, result


def assert_same_log_psi(got: np.ndarray, want: np.ndarray, rtol: float) -> None:
    assert np.abs(got.real - want.real).max() <= rtol * np.abs(want.real).max()
    np.testing.assert_allclose(np.exp(1j * (got.imag - want.imag)), 1.0, atol=rtol)


def observables(network, data):
    return torch.func.vmap(hamiltonian.local_energy(network, SYSTEM))(data)


def test_ed_ground_is_laughlin_at_n3(laughlin_block):
    """N=3, 2Q=6: a unique L=0 state, so the ED ground state is Laughlin's; and
    the port's evaluator gives the JAX package's log psi."""
    network, result = laughlin_block
    assert abs(result.ground_l2) < 1e-8
    data = walkers(12, 3, seed=0)
    with torch.no_grad():
        # In float64: a walker near a node loses digits in float32.
        got = network(data.double())
        diff = (got - Laughlin((3, 0), 6)(data.double())).numpy()
    assert np.ptp(diff.real) < 1e-5
    np.testing.assert_allclose(np.exp(1j * (diff.imag - diff.imag[0])), 1.0 + 0j, atol=1e-5)
    with jax.enable_x64(True):
        jax_network, _ = jax_make_ed_network(jax_config.System(flux=6, nspins=(3, 0)))
        want = np.asarray(jax_network(None, jnp.asarray(data.numpy(), dtype=jnp.float64)))
    assert_same_log_psi(got.numpy(), want, 1e-10)


@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-8), (torch.float32, 1e-4)])
def test_pointwise_kinetic_and_l2(laughlin_block, dtype, atol):
    network, _ = laughlin_block
    el, obs = observables(network, walkers(8, 3, seed=1).to(dtype))
    np.testing.assert_allclose(obs["kinetic"].numpy(), 1.5, atol=atol)
    np.testing.assert_allclose(obs["angular_momentum_square"].numpy(), 0.0, atol=atol)
    np.testing.assert_allclose(obs["angular_momentum_z"].numpy(), 0.0, atol=atol)
    # Pointwise el = N/2 + V(x) fluctuates; it must still be real.
    np.testing.assert_allclose(el.imag.numpy(), 0.0, atol=atol)


def test_excited_eigenstate_l2_pointwise():
    """State index 1 of the N=3, 2Q=6 block: the multiplet's L^2 at every walker."""
    res = ed.ed_block(3, 6, two_lz=0)
    v1 = res.states[:, 1]
    l2_exact = float(v1 @ ed._apply_total_l2(6, res.basis, v1))
    assert l2_exact > 1
    logpsi = make_ed_logpsi(res, 6, state=1)
    _, obs = observables(logpsi, walkers(6, 3, seed=2).double())
    np.testing.assert_allclose(obs["angular_momentum_square"].numpy(), l2_exact, atol=1e-8)
    np.testing.assert_allclose(obs["kinetic"].numpy(), 1.5, atol=1e-8)


def test_mean_local_energy_is_eigenvalue(laughlin_block):
    """The mean of E_L over |psi_ED|^2 walkers equals N/2 + E0 (statistical)."""
    network, result = laughlin_block
    step = mcmc.make_mcmc_step(network, steps=10)
    generator = torch.Generator().manual_seed(4)
    data = walkers(512, 3, seed=3)
    with torch.no_grad():
        for _ in range(60):
            data, _ = step(data, 0.3, generator)
    el, _ = observables(network, data)
    assert abs(el.real.mean().item() - result.total_energy(3)) < 0.05


@pytest.mark.parametrize("nelec,two_q,two_lz", [(3, 6, 0), (4, 9, 2)])
def test_ed_copy_matches_jax(nelec, two_q, two_lz):
    got = ed.ed_block(nelec, two_q, two_lz=two_lz)
    want = jax_ed.ed_block(nelec, two_q, two_lz=two_lz)
    assert got.dim == want.dim and got.basis == want.basis
    np.testing.assert_allclose(got.energies, want.energies, rtol=0, atol=1e-12)
    assert abs(got.ground_l2 - want.ground_l2) < 1e-12
    got = ed_native.ed_ground_lanczos(nelec, two_q, two_lz=two_lz, tol=1e-12)
    want = jax_ed_native.ed_ground_lanczos(nelec, two_q, two_lz=two_lz, tol=1e-12)
    np.testing.assert_allclose(got.energies, want.energies, rtol=0, atol=1e-12)
    assert abs(got.ground_l2 - want.ground_l2) < 1e-10
    assert ed_native._build_library().parent.name == "deephall_tpu_torch"


def test_max_dim_guard():
    system = config.System(flux=15, nspins=(6, 0))
    with pytest.raises(ValueError) as got:
        make_ed_network(system, max_dim=100)
    with pytest.raises(ValueError) as want:
        jax_make_ed_network(jax_config.System(flux=15, nspins=(6, 0)), max_dim=100)
    assert str(got.value) == str(want.value) and "338 states" in str(got.value)


def test_logpsi_matches_jax_for_an_excited_state():
    res = jax_ed.ed_block(4, 9, two_lz=2)
    data = walkers(5, 4, seed=6).double()
    with jax.enable_x64(True):
        want = np.asarray(jax_make_ed_logpsi(res, 9, state=2)(jnp.asarray(data.numpy())))
    assert_same_log_psi(make_ed_logpsi(res, 9, state=2)(data).numpy(), want, 1e-10)
