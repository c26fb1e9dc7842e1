"""The port's netobs bridge against the JAX package's, on a stubbed netobs.

netobs is not installed.  A torch copy of the in-memory stub of
``tests/test_netobs_bridge.py`` (the adaptor base without the pytree methods,
the estimator and observable bases, the electron-gas system) stands in for it
while the port's bridge is imported; the JAX bridge is imported under that
file's own stub.  ``sys.modules`` is restored afterwards.

A tiny analytic Laughlin run (N=3, 2Q=6, batch 64) is saved once and restored
through both bridges; its walkers are equilibrated by the JAX walking step and
then handed to both.  Against the JAX bridge on the same walkers:

* log psi, the potential energy, and each estimator's per-walker values, state
  and digest in float32, within 1e-5 of the largest value (phases mod 2 pi);
  the 1-RDM with the same insertion points in both;
* the kinetic energy, which the port takes in float64 for an analytic state,
  against the JAX bridge's evaluated in float64 (``jax.enable_x64``) within
  1e-5 relative, and within 1e-6 of the lowest-Landau-level value N/2.

The walking step moves walkers and keeps ``mcmc_width``; without netobs the
package raises an ``ImportError`` that names the port's runner.
"""

from __future__ import annotations

import importlib
import os
import subprocess
import sys
import types
from pathlib import Path
from typing import Any, Generic, TypedDict, TypeVar

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_netobs_bridge import _install_netobs_stub as install_jax_stub

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
S = TypeVar("S")
TOL = 1e-5
ESTIMATORS = ("density", "pair_corr", "one_rdm", "overlap")


def install_torch_stub() -> dict:
    """Fake netobs modules with the API the port's bridge uses (no pytrees)."""

    class ElectronGas(TypedDict):
        spins: list[int]
        ndim: int

    class NetworkAdaptor(Generic[S]):
        def __init__(self, config: Any, args: list[str]):
            self.config = config
            self.args = args

        def call_network(self, params, electrons, system):
            return self.call_signed_network(params, electrons, system)[1]

    class Observable(Generic[S]):
        def __init__(self, system=None, options=None):
            self.system = system
            self.options = options or {}

        def shapeof(self, system) -> tuple[int, ...]:
            del system
            return ()

        @property
        def shape(self) -> tuple[int, ...]:
            return self.shapeof(self.system)

    class Estimator(Generic[S]):
        observable_type = Observable

        def __init__(self, adaptor, system, estimator_options, observable_options):
            self.adaptor = adaptor
            self.system = system
            self.options = estimator_options or {}
            self.observable = self.observable_type(system, observable_options)

    class Density(Observable):
        pass

    mods = {name: types.ModuleType(name) for name in (
        "netobs", "netobs.adaptors", "netobs.observables", "netobs.observables.density",
        "netobs.systems", "netobs.systems.elec_gas")}
    mods["netobs.adaptors"].NetworkAdaptor = NetworkAdaptor
    mods["netobs.adaptors"].WalkingStep = Any
    mods["netobs.observables"].Estimator = Estimator
    mods["netobs.observables"].Observable = Observable
    mods["netobs.observables.density"].Density = Density
    mods["netobs.systems.elec_gas"].ElectronGas = ElectronGas
    for name in ("adaptors", "observables", "systems"):
        setattr(mods["netobs"], name, mods[f"netobs.{name}"])
    return mods


def import_bridge(package: str, stub: dict) -> dict:
    """The adaptor and estimator modules of ``package.netobs_bridge`` under ``stub``."""
    sys.modules.update(stub)
    for name in list(sys.modules):
        if name.startswith(f"{package}.netobs_bridge"):
            del sys.modules[name]
    bridge = {"adaptor": importlib.import_module(f"{package}.netobs_bridge.adaptor")}
    for name in ESTIMATORS:
        bridge[name] = importlib.import_module(f"{package}.netobs_bridge.observables.{name}")
    return bridge


@pytest.fixture(scope="module")
def bridges(tmp_path_factory):
    names = [n for n in sys.modules if n == "netobs" or n.startswith("netobs.")]
    saved = {name: sys.modules[name] for name in names}
    try:
        jax_bridge = import_bridge("deephall_tpu", install_jax_stub())
        from deephall_tpu.config import Config
        from deephall_tpu.log import CheckpointState, LogManager
        from deephall_tpu.train import init_guess

        run_dir = tmp_path_factory.mktemp("laughlin_run")
        cfg = Config()
        cfg.seed, cfg.batch_size = 11, 64
        cfg.system.nspins, cfg.system.flux = (3, 0), 6
        cfg.network.type = "laughlin"
        cfg.log.save_path = str(run_dir)
        data = init_guess(jax.random.PRNGKey(0), cfg.batch_size, 3)
        LogManager(cfg).save_checkpoint(
            41, CheckpointState({}, np.asarray(data), None, np.float32(0.3)))
        ckpt = str(run_dir / "ckpt_000041.npz")

        jax_adaptor = jax_bridge["adaptor"].DeepHallAdaptor(config=None, args=[])
        jax_params, walkers, jax_system, jax_aux = jax_adaptor.restore(ckpt)
        batch_log_psi = jax.vmap(jax_adaptor.call_network, in_axes=(None, 0, None))
        walk = jax_adaptor.make_walking_step(batch_log_psi, steps=10, system=jax_system)
        key = jax.random.PRNGKey(5)
        for _ in range(10):
            key, subkey = jax.random.split(key)
            walkers, jax_aux = walk(subkey, jax_params, walkers, jax_aux)

        torch_bridge = import_bridge("deephall_tpu_torch", install_torch_stub())
        adaptor = torch_bridge["adaptor"].DeepHallAdaptor(config=None, args=["--device", "cpu"])
        restored = adaptor.restore(ckpt)
        yield dict(
            jax=(jax_bridge, jax_adaptor, jax_params, jax_system, jax_aux),
            torch=(torch_bridge, adaptor, *restored),
            walkers=np.array(walkers),
        )
    finally:
        for name in list(sys.modules):
            if (name == "netobs" or name.startswith("netobs.")) and name not in saved:
                del sys.modules[name]
            if name.startswith(("deephall_tpu.netobs_bridge", "deephall_tpu_torch.netobs_bridge")):
                del sys.modules[name]
        sys.modules.update(saved)


def assert_close(got, want, tol: float = TOL, err_msg: str = "") -> None:
    """Within ``tol`` of the largest ``|want|``."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * np.abs(want).max(), err_msg=err_msg)


def test_import_guard():
    saved = {n: sys.modules.pop(n) for n in list(sys.modules)
             if n == "netobs" or n.startswith(("netobs.", "deephall_tpu_torch.netobs_bridge"))}
    try:
        with pytest.raises(ImportError, match="deephall_tpu_torch.observables.runner"):
            importlib.import_module("deephall_tpu_torch.netobs_bridge")
    finally:
        sys.modules.update(saved)


def test_restore_surface(bridges):
    _, adaptor, params, walkers, system, aux = bridges["torch"]
    jax_aux = bridges["jax"][4]
    assert adaptor.device == torch.device("cpu")
    assert params == dict(adaptor.network.state_dict()) == {}
    assert (system["flux"], system["spins"], system["ndim"]) == (6, [3, 0], 2)
    assert walkers.shape == (64, 3, 2) and walkers.dtype == torch.float32
    assert float(aux["mcmc_width"]) == pytest.approx(0.3) == float(jax_aux["mcmc_width"])
    sign, logpsi = adaptor.call_signed_network(params, walkers[0], system)
    assert float(sign) == 1.0 and logpsi.is_complex()


def test_cuda_is_the_default_device():
    stub = install_torch_stub()
    saved = {n: sys.modules.get(n) for n in stub}
    try:
        module = import_bridge("deephall_tpu_torch", stub)["adaptor"]
        assert module.DeepHallAdaptor(config=None, args=[]).device == "cuda"
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA was requested"):
                module.DeepHallAdaptor(config=None, args=[]).restore("unused.npz")
    finally:
        for name, mod in saved.items():
            if mod is None:
                sys.modules.pop(name, None)
            else:
                sys.modules[name] = mod
        for name in list(sys.modules):
            if name.startswith("deephall_tpu_torch.netobs_bridge"):
                del sys.modules[name]


def test_log_psi_and_energies_match_jax(bridges):
    _, jax_adaptor, jax_params, jax_system, _ = bridges["jax"]
    _, adaptor, params, _, system, _ = bridges["torch"]
    walkers = bridges["walkers"]
    x = torch.from_numpy(walkers)
    got = torch.func.vmap(lambda e: adaptor.call_network(params, e, system))(x).numpy()
    want = np.asarray(jax.vmap(lambda e: jax_adaptor.call_network(jax_params, e, jax_system))(
        jnp.asarray(walkers)))
    assert_close(got.real, want.real, err_msg="Re log psi")
    np.testing.assert_allclose(np.exp(1j * (got.imag - want.imag)), 1.0, atol=TOL)

    potential = torch.func.vmap(
        lambda e: adaptor.call_local_potential_energy(params, None, e, system))(x)
    want_pe = jax.vmap(lambda e: jax_adaptor.call_local_potential_energy(
        jax_params, None, e, jax_system))(jnp.asarray(walkers))
    np.testing.assert_allclose(potential.numpy(), np.asarray(want_pe), rtol=TOL)

    kinetic = torch.func.vmap(
        lambda e: adaptor.call_local_kinetic_energy(params, None, e, system))(x).numpy()
    assert kinetic.dtype == np.complex128
    with jax.enable_x64(True):
        want_ke = np.asarray(jax.vmap(lambda e: jax_adaptor.call_local_kinetic_energy(
            jax_params, None, e, jax_system))(jnp.asarray(walkers, dtype=jnp.float64)))
    assert want_ke.dtype == np.complex128
    np.testing.assert_allclose(kinetic, want_ke, rtol=TOL)
    np.testing.assert_allclose(kinetic, 1.5, rtol=0, atol=1e-6)


def test_walking_step_moves_and_keeps_width(bridges):
    _, adaptor, params, walkers, system, aux = bridges["torch"]
    batch_log_psi = torch.func.vmap(adaptor.call_network, in_dims=(None, 0, None))
    walk = adaptor.make_walking_step(batch_log_psi, steps=5, system=system)
    key = torch.Generator().manual_seed(3)
    moved, new_aux = walk(key, params, walkers, aux)
    assert moved.shape == walkers.shape and torch.isfinite(moved).all()
    assert (moved != walkers).any(dim=(1, 2)).float().mean() > 0.5
    assert new_aux["mcmc_width"] is aux["mcmc_width"]
    assert float(new_aux["mcmc_width"]) == pytest.approx(0.3)


def test_overlap_estimator_matches_jax(bridges):
    jax_bridge, jax_adaptor, jax_params, jax_system, _ = bridges["jax"]
    torch_bridge, adaptor, params, _, system, _ = bridges["torch"]
    walkers = bridges["walkers"]
    jax_est = jax_bridge["overlap"].OverlapEstimator(jax_adaptor, jax_system, {}, {})
    est = torch_bridge["overlap"].OverlapEstimator(adaptor, system, {}, {})
    steps = 3
    jax_values, jax_state = jax_est.empty_val_state(steps)
    values, state = est.empty_val_state(steps)
    for i in range(steps):
        jax_step, jax_state = jax_est.evaluate(i, jax_params, jax.random.PRNGKey(i),
                                               jnp.asarray(walkers), jax_system, jax_state, None)
        step, state = est.evaluate(i, params, torch.Generator().manual_seed(i),
                                   torch.from_numpy(walkers), system, state, None)
        for key in ("ratio", "ratio_square"):
            assert step[key].shape == (64,)
            assert_close(step[key].numpy(), np.asarray(jax_step[key]), err_msg=key)
            jax_values[key] = jax_values[key].at[i].set(jnp.nanmean(jax_step[key]))
            values[key][i] = step[key].mean()
    got, want = est.digest(values, state), jax_est.digest(jax_values, jax_state)
    assert float(got["overlap"]) == pytest.approx(float(want["overlap"]), rel=TOL)
    assert float(got["overlap"]) == pytest.approx(1.0, abs=1e-4)


def test_one_rdm_estimator_matches_jax(bridges, monkeypatch):
    jax_bridge, jax_adaptor, jax_params, jax_system, _ = bridges["jax"]
    torch_bridge, adaptor, params, _, system, _ = bridges["torch"]
    walkers = bridges["walkers"]
    rng = np.random.default_rng(4)
    steps = 2
    points = np.stack([np.arccos(rng.uniform(-1, 1, (steps, 64))),
                       rng.uniform(-np.pi, np.pi, (steps, 64))], -1).astype(np.float32)
    monkeypatch.setattr(jax_bridge["one_rdm"], "sample_insertion_points",
                        lambda key, shape: jnp.asarray(points[int(key[-1])]))
    monkeypatch.setattr(torch_bridge["one_rdm"], "sample_insertion_points",
                        lambda key, shape, device: torch.from_numpy(points[key.initial_seed()]))
    jax_est = jax_bridge["one_rdm"].OneRDMEstimator(jax_adaptor, jax_system, {}, {})
    est = torch_bridge["one_rdm"].OneRDMEstimator(adaptor, system, {}, {})
    jax_values, jax_state = jax_est.empty_val_state(steps)
    values, state = est.empty_val_state(steps)
    assert values["one_rdm"].shape == (steps, 7, 7)
    for i in range(steps):
        jax_step, jax_state = jax_est.evaluate(i, jax_params, jax.random.PRNGKey(i),
                                               jnp.asarray(walkers), jax_system, jax_state, None)
        step, state = est.evaluate(i, params, torch.Generator().manual_seed(i),
                                   torch.from_numpy(walkers), system, state, None)
        assert step["one_rdm"].shape == (64, 7, 7)
        assert_close(step["one_rdm"].numpy(), np.asarray(jax_step["one_rdm"]), err_msg="one_rdm")
        jax_values["one_rdm"] = jax_values["one_rdm"].at[i].set(jnp.mean(jax_step["one_rdm"], 0))
        values["one_rdm"][i] = step["one_rdm"].mean(dim=0)
    got, want = est.digest(values, state), jax_est.digest(jax_values, jax_state)
    for key in ("diagonal", "trace"):
        assert_close(got[key].numpy(), np.asarray(want[key]), err_msg=key)


def test_density_and_pair_corr_match_jax(bridges):
    jax_bridge, jax_adaptor, jax_params, jax_system, jax_aux = bridges["jax"]
    torch_bridge, adaptor, params, _, system, aux = bridges["torch"]
    walkers = bridges["walkers"]
    for name, cls, key, options in (("density", "DensityEstimator", "map", {"bins": 25}),
                                    ("pair_corr", "PairCorrelationEstimator", "pair_corr", {})):
        jax_est = getattr(jax_bridge[name], cls)(jax_adaptor, jax_system, options, {})
        est = getattr(torch_bridge[name], cls)(adaptor, system, options, {})
        _, jax_state = jax_est.empty_val_state(2)
        _, state = est.empty_val_state(2)
        for i in range(2):
            _, jax_state = jax_est.evaluate(i, jax_params, None, jnp.asarray(walkers), jax_system,
                                            jax_state, jax_aux)
            _, state = est.evaluate(i, params, None, torch.from_numpy(walkers), system, state, aux)
        assert_close(state[key].numpy(), np.asarray(jax_state[key]), err_msg=name)
        assert est.digest({}, state) == {}
    assert float(state["pair_corr"].sum()) > 0


NO_JAX = """
import sys, types, typing
stub = {n: types.ModuleType(n) for n in (
    "netobs", "netobs.adaptors", "netobs.observables", "netobs.observables.density",
    "netobs.systems", "netobs.systems.elec_gas")}
S = typing.TypeVar("S")


class Base(typing.Generic[S]):
    def __init__(self, *args):
        pass


stub["netobs.adaptors"].NetworkAdaptor, stub["netobs.adaptors"].WalkingStep = Base, typing.Any
stub["netobs.observables"].Estimator = stub["netobs.observables"].Observable = Base
stub["netobs.observables.density"].Density = Base
stub["netobs.systems.elec_gas"].ElectronGas = dict
sys.modules.update(stub)
import importlib
for name in ("adaptor", "observables.density", "observables.pair_corr", "observables.one_rdm",
             "observables.overlap", "cli_extend"):
    importlib.import_module("deephall_tpu_torch.netobs_bridge." + name)
sys.path.insert(0, "scripts")
import chip_smoke, magnetoroton_torch, torch_laughlin_pole_probe, torch_trace_summary
import dispersion_report_torch, torch_bench_jet_attention, torch_bench_sublane_layout
import torch_capture_trace, torch_flops_count, torch_production_block, torch_profile_step
import torch_local_energy_timing, torch_psiformer_pole_probe, torch_softmax_values_timing
import torch_state_observables
torch_production_block.build_production_block(False, 1, "cpu", batch=4, nelec=3, flux=4,
                                              num_layers=1, num_heads=1, heads_dim=4)
dispersion_report_torch.sector_ed_anchor(3, 6, 1)
magnetoroton_torch.plan_phases(0, 1.0, 1.0, 0, 100, one_sided=True, m=2)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "deephall_tpu"))
assert not bad, bad
print("CLEAN")
"""


def test_new_modules_import_no_jax():
    # The bridge (under a minimal netobs stub), the sector driver, the trace
    # summary, the pole probes, the measurement tools (a production block built,
    # an ED anchor found) and chip_smoke.py import nothing of JAX or of the
    # JAX package.
    out = subprocess.run([sys.executable, "-c", NO_JAX], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)})
    assert out.returncode == 0 and out.stdout.split() == ["CLEAN"], out.stderr
