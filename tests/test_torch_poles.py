"""The analytic Laughlin state's local energy with an electron near a pole.

The N=6, 2Q=15 Laughlin state is a lowest-Landau-level L^2 = 0 eigenstate: at
every walker its local kinetic energy is N Q / (2 R^2) = 3 and its local L^2
is 0.  Both divide by powers of sin(theta), and in float32 they lose digits as
1/eps^2 for an electron at eps from a pole (the kinetic energy read 68 at
pi - 1e-4).  On the float32 walkers of
``scripts/torch_laughlin_pole_probe.py:pole_walkers`` (one electron at
theta = pi - eps and at eps for eps in {1e-3, 1e-4, 1e-5}, then ordinary
walkers), through the port's ``loss.batched_local_energy``:

* every walker's kinetic energy within 1e-4 of 3 and |L^2| <= 1e-4;
* against the JAX package evaluated in float64 (``jax.enable_x64``), E_L and
  every observable within 1e-6 where that evaluation is itself within 1e-6 of
  the exact values (the ordinary walkers and eps = 1e-3).  Nearer the pole
  the reference's own float64 error grows past 1e-6 (its polar terms are
  summed one by one); there it is held to the same 1e-4 as the port;
* on the ordinary walkers, E_L and the kinetic energy against the JAX
  package in float32 within 2e-3 (``tests/test_torch_hamiltonian.py``'s
  float32 tolerance).
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import hamiltonian as jax_hamiltonian
from deephall_tpu.networks.laughlin import Laughlin as JaxLaughlin
from deephall_tpu_torch import loss

torch.set_num_threads(2)

PROBE = Path(__file__).resolve().parents[1] / "scripts" / "torch_laughlin_pole_probe.py"
OBSERVABLES = ("kinetic", "potential", "angular_momentum_z", "angular_momentum_z_square",
               "angular_momentum_square")
POLE_TOL, JAX64_TOL, JAX32_TOL = 1e-4, 1e-6, 2e-3


def load_probe():
    spec = importlib.util.spec_from_file_location("torch_laughlin_pole_probe", PROBE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def energies():
    """The port's values and the JAX package's in float64 and float32, as numpy."""
    probe = load_probe()
    data = probe.pole_walkers(walkers=12)
    cfg, model = probe.laughlin()
    with torch.no_grad():
        el, obs = loss.batched_local_energy(model, cfg.system)(torch.from_numpy(data))
    port = {"energy": el.numpy(), **{k: obs[k].numpy() for k in OBSERVABLES}}

    jcfg = jax_config.Config()
    jcfg.system.nspins, jcfg.system.flux = (probe.NELEC, 0), probe.FLUX
    jmodel = JaxLaughlin(nspins=(probe.NELEC, 0), flux=probe.FLUX)

    def jax_values(x):
        fn = jax.vmap(jax_hamiltonian.local_energy(jmodel.apply, jcfg.system), in_axes=(None, 0))
        el, obs = jax.jit(fn)({}, x)
        return {"energy": np.asarray(el), **{k: np.asarray(obs[k]) for k in OBSERVABLES}}

    with jax.enable_x64(True):
        jax64 = jax_values(jnp.asarray(data, dtype=jnp.float64))
    jax32 = jax_values(jnp.asarray(data))
    return probe, port, jax64, jax32


def test_port_is_exact_near_a_pole(energies):
    probe, port, _, _ = energies
    np.testing.assert_allclose(port["kinetic"], probe.KINETIC, rtol=0, atol=POLE_TOL)
    np.testing.assert_allclose(port["angular_momentum_square"], 0.0, rtol=0, atol=POLE_TOL)
    np.testing.assert_allclose(port["angular_momentum_z"], 0.0, rtol=0, atol=POLE_TOL)
    assert port["energy"].dtype == np.complex128


def test_against_jax_in_float64(energies):
    probe, port, jax64, _ = energies
    exact = (np.abs(jax64["kinetic"] - probe.KINETIC) <= JAX64_TOL) & (
        np.abs(jax64["angular_momentum_square"]) <= JAX64_TOL)
    pole = 2 * len(probe.POLE_EPS)
    # The reference is exact on the ordinary walkers and at eps = 1e-3 ...
    assert exact[pole:].all() and exact[[0, len(probe.POLE_EPS)]].all()
    for key in ("energy", *OBSERVABLES):
        np.testing.assert_allclose(port[key][exact], jax64[key][exact], rtol=0, atol=JAX64_TOL,
                                   err_msg=key)
    # ... and within the port's own bound nearer the pole.
    np.testing.assert_allclose(jax64["kinetic"], probe.KINETIC, rtol=0, atol=POLE_TOL)
    np.testing.assert_allclose(jax64["angular_momentum_square"], 0.0, rtol=0, atol=POLE_TOL)


def test_ordinary_walkers_against_jax_in_float32(energies):
    probe, port, _, jax32 = energies
    ordinary = slice(2 * len(probe.POLE_EPS), None)
    for key in ("energy", "kinetic"):
        np.testing.assert_allclose(port[key][ordinary], jax32[key][ordinary], rtol=JAX32_TOL,
                                   atol=JAX32_TOL, err_msg=key)
