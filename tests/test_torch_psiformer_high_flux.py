"""The Psiformer at high flux (2Q=65: 66 monopole harmonics, more than one
column tile of the orbital head's kernel holds) in the port, against the
benchmark's plain reference.

The configuration ``psiformer_n14_q65`` runs the nu=1/5 Laughlin sequence
at N=14, 2Q=65: the envelope raises its two factors to powers up to 65 with
norms up to sqrt(C(65, 32)) ~ 1.9e9, and the kinetic and gauge terms grow
with Q.  Here the same flux at N=4 and small widths (2 layers, 2 heads x 8,
one determinant), in float64 on both sides, on seeded random weights moved
off flax's initial values, at walkers of which some lie within 1e-3 of each
pole: ``benchmark/reference/psiformer.py`` with its own LU and
``energy.observables`` by the full Hessian through autograd, ``vmc`` for
the clipped gradient, the KFAC capture and one KFAC step; the port's
``Psiformer.forward``, its forward-Laplacian jet with the plain kernels,
``loss.gradient_and_capture`` and ``optimizers.kfac``.  Then the orbital
head's decomposition that the kernel takes on the card at more than
:data:`orbital_head.MAX_HARMONICS` harmonics: its plain version on each of
:func:`orbital_head.harmonic_ranges`' slices of the head and the envelope,
added, is the whole head's.
"""

from __future__ import annotations

import copy
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.reference import energy, psiformer, vmc  # noqa: E402
from deephall_tpu_torch import hamiltonian, loss  # noqa: E402
from deephall_tpu_torch.config import (  # noqa: E402
    Config,
    dotlist_to_dict,
    merge_dicts,
    resolve_interpolations,
    to_dict,
)
from deephall_tpu_torch.networks import fwdlap as network_jet  # noqa: E402
from deephall_tpu_torch.networks import make_network  # noqa: E402
from deephall_tpu_torch.ops import orbital_head  # noqa: E402
from deephall_tpu_torch.ops.fwdlap import Jet  # noqa: E402
from deephall_tpu_torch.optimizers import kfac  # noqa: E402
from deephall_tpu_torch.types import KfacState  # noqa: E402
from deephall_tpu_torch.weights import init_params  # noqa: E402

torch.set_num_threads(2)

NSPINS, FLUX, LAYERS, HEADS, DETS, BATCH = (4, 0), 65, 2, 2, 1, 6
HEAD_BLOCKS = ("Orbitals_0/featured_orbitals/DenseGeneral_0",
               "Orbitals_0/featured_orbitals/DenseGeneral_1")
KFAC = {"rate": 0.05, "decay": 1.0, "delay": 2000.0, "damping": 1e-3, "curvature_ema": 0.95,
        "norm_constraint": 1e-3}
# Electron 0 of the first four walkers this far from a pole (north, north,
# south, south); the other walkers and electrons are drawn uniformly.
POLE_GAPS = (1e-3, 4e-4, 1e-3, 4e-4)
# As tests/test_torch_psiformer_l4k16.py: float64 on both sides, the port's
# envelope norms float32 constants (off by up to 6e-8 of each); 1e-6 of a
# value's scale.  At the poles the reference's full Hessian divides by
# sin^2 theta (1.6e-7 at 4e-4), which the port's pole-regular jet never
# does, and still keeps these digits in float64.
RTOL = 1e-6


def close(got, want, rtol=RTOL):
    """``got`` within ``rtol`` of ``want``'s largest magnitude (at least 1)."""
    got, want = torch.as_tensor(got), torch.as_tensor(want)
    scale = max(float(want.abs().max()), 1.0)
    return float((got - want).abs().max()) <= rtol * scale


@pytest.fixture(scope="module")
def setup():
    """The port's model in float64, its weights as the reference's leaves, and walkers."""
    dotlist = [f"system.nspins=[{NSPINS[0]},{NSPINS[1]}]", f"system.flux={FLUX}",
               f"network.psiformer.num_layers={LAYERS}", f"network.psiformer.num_heads={HEADS}",
               "network.psiformer.heads_dim=8", f"network.psiformer.determinants={DETS}",
               "system.compute_l2=true", f"batch_size={BATCH}"]
    cfg = Config.from_dict(resolve_interpolations(merge_dicts(to_dict(Config()), dotlist_to_dict(dotlist))))
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(23))
    moves = torch.Generator().manual_seed(24)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=moves))
    model = model.double()
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(25)
    theta = np.arccos(rng.uniform(-0.95, 0.95, (BATCH, sum(NSPINS))))
    theta[:2, 0] = POLE_GAPS[:2]
    theta[2:4, 0] = np.pi - np.array(POLE_GAPS[2:])
    phi = rng.uniform(-np.pi, np.pi, (BATCH, sum(NSPINS)))
    x = torch.from_numpy(np.stack([theta, phi], -1))
    spec = psiformer.Spec(NSPINS, FLUX, HEADS, LAYERS)
    return cfg, model, params, spec, x


def test_the_network_has_more_harmonics_than_a_tile_holds(setup):
    _, _, params, _, x = setup
    kernel = params["Orbitals_0.featured_orbitals.DenseGeneral_0.kernel"]
    assert kernel.shape[1] == FLUX + 1 > orbital_head.MAX_HARMONICS
    assert len(orbital_head.harmonic_ranges(FLUX + 1)) == 2
    gaps = torch.minimum(x[..., 0], math.pi - x[..., 0]).amin(-1)
    assert (gaps[:2] <= 1e-3).all() and (gaps[2:4] <= 1e-3).all()


def test_log_psi(setup):
    _, model, params, spec, x = setup
    with torch.no_grad():
        got = model(x)
    want = psiformer.logpsi(params, spec, x)
    assert close(got.real, want.real)
    assert close(torch.remainder(got.imag - want.imag + math.pi, 2 * math.pi) - math.pi, 0.0)


@pytest.fixture(scope="module")
def reference_observables(setup):
    _, _, params, spec, x = setup
    return energy.observables(lambda y: psiformer.logpsi(params, spec, y), x, FLUX)


@pytest.mark.parametrize("key", ["energy", "kinetic", "potential", "angular_momentum_z",
                                 "angular_momentum_z_square", "angular_momentum_square"])
def test_the_jet_local_energy(setup, reference_observables, key):
    """The forward-Laplacian jet with L^2 (plain kernels) against the
    reference's full Hessian, walker by walker."""
    cfg, model, _, _, x = setup
    with torch.no_grad():
        el, obs = hamiltonian.forward_laplacian_local_energy(model, cfg.system, kernels=False)(x)
    got = el if key == "energy" else obs[key]
    want = reference_observables[key]
    assert close(got, want), (key, got, want)


def specs_of(model):
    """KFAC's blocks, found by a float32 forward of a copy (``kfac.discover``)."""
    return kfac.discover(copy.deepcopy(model).float(), sum(NSPINS))


@pytest.fixture(scope="module")
def both_gradients(setup, reference_observables):
    """Each side's clipped energy gradient and KFAC capture from its own local energy."""
    cfg, model, params, spec, x = setup
    with torch.no_grad():
        el, obs = hamiltonian.forward_laplacian_local_energy(model, cfg.system, kernels=False)(x)
    _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, x, el, obs)
    system = {"compute_l2": True, "dynamic_penalties": False, "l2_adaptive": False,
              "lz_penalty": 0.0, "lz_center": 0.0, "l2_penalty": 0.0, "l2_center": 0.0,
              "overlap_penalty": 1.0}
    _, diff = vmc.stats_and_diff(system, reference_observables)
    ref = vmc.gradient_and_curvature(params, spec, x, vmc.weights(diff))
    return (grads, inputs, dy), ref


def test_the_gradient(both_gradients):
    (grads, _, _), (ref_grads, _, _) = both_gradients
    assert set(grads) == set(ref_grads)
    scale = max(float(g.abs().max()) for g in ref_grads.values())
    for name, g in grads.items():
        assert close(g.reshape(ref_grads[name].shape), ref_grads[name], RTOL * scale), name


@pytest.mark.parametrize("path", HEAD_BLOCKS)
def test_the_orbital_blocks_factors(setup, both_gradients, path):
    """The head's Kronecker factors, ``A`` of its inputs with a ones column
    and ``G`` of its outputs' Fisher sensitivities, over 66 harmonics."""
    _, model, _, _, _ = setup
    (_, inputs, dy), (_, ref_inputs, ref_dy) = both_gradients
    specs = [s for s in specs_of(model) if s.path == path]
    kron, _ = kfac.factor_update(specs, inputs, dy)
    a = torch.cat([ref_inputs[path], torch.ones_like(ref_inputs[path][:, :1])], 1)
    rows = a.shape[0]
    assert rows == BATCH * sum(NSPINS)
    assert close(kron[path]["a"], a.T @ a / rows)
    assert close(kron[path]["g"], ref_dy[path].T @ ref_dy[path] / rows)
    assert kron[path]["g"].shape == ((FLUX + 1) * sum(NSPINS) * DETS,) * 2


def test_one_kfac_step_from_zero_curvature(setup, both_gradients):
    """KFAC's first step from the state ``opt_init`` makes, as the fresh
    checkpoint of the configuration stores it."""
    cfg, model, params, _, _ = setup
    (grads, inputs, dy), (ref_grads, ref_inputs, ref_dy) = both_gradients
    specs = specs_of(model)

    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float64)

    state = KfacState(
        {s.path: {"a": zeros(s.fan_in + s.has_bias, s.fan_in + s.has_bias), "g": zeros(s.fan_out, s.fan_out)}
         for s in specs if s.kind == "kron"},
        {s.path: {"scale": zeros(s.fan_out), "bias": zeros(s.fan_out)} for s in specs if s.kind == "diag"},
        zeros(), torch.zeros((), dtype=torch.int32))
    port = {k: p.detach().clone() for k, p in model.named_parameters()}
    optim = cfg.optim.kfac
    optim.lr.rate, optim.lr.decay, optim.lr.delay = KFAC["rate"], KFAC["decay"], KFAC["delay"]
    optim.damping, optim.curvature_ema, optim.norm_constraint = (
        KFAC["damping"], KFAC["curvature_ema"], KFAC["norm_constraint"])
    new_state, info = kfac.kfac_update(optim, specs, port, state, grads, inputs, dy)
    curvature = {"kron": {p: {f: v.clone() for f, v in b.items()} for p, b in state.kron.items()},
                 "diag": {p: {f: v.clone() for f, v in b.items()} for p, b in state.diag.items()},
                 "weight": zeros(), "step": torch.zeros((), dtype=torch.int32)}
    ref_params, ref_curvature, ref_info = vmc.kfac_step(params, curvature, ref_grads, ref_inputs, ref_dy,
                                                        BATCH, KFAC)
    for path in HEAD_BLOCKS:
        assert close(new_state.kron[path]["g"], ref_curvature["kron"][path]["g"])
    assert float(info["quadratic_norm"]) == pytest.approx(ref_info["quadratic_norm"], rel=RTOL)
    assert float(info["norm_coefficient"]) == pytest.approx(ref_info["norm_coefficient"], rel=RTOL)
    for name, p in port.items():
        start = params[name]
        change, ref_change = p.reshape(start.shape) - start, ref_params[name] - start
        assert close(change, ref_change, RTOL * float(ref_change.abs().max())), name


def test_the_harmonic_ranges_add_up_to_the_head(setup, monkeypatch):
    """The model's own head, tower jet and envelope jet at these walkers (the
    arguments of the plain version inside ``psiformer_logpsi_jet``): its plain
    version on each harmonic range's slices of the head and the envelope,
    added, equals the whole head's, field by field (float64)."""
    _, model, _, _, x = setup
    seen = []

    def spy(p, h, env, nspins):
        seen.append((p, h, env, nspins))
        return orbital_head.orbital_matrices_plain(p, h, env, nspins)

    monkeypatch.setattr(orbital_head, "orbital_matrices_jet", spy)
    with torch.no_grad():
        network_jet.psiformer_logpsi_jet(model, x, compute_l2=True, kernels=True)
    (p, h, env, nspins), = seen
    whole = orbital_head.orbital_matrices_plain(p, h, env, nspins)
    parts = [orbital_head.orbital_matrices_plain(
        {name: orbital_head.harmonic_slice(dense, f0, f1) for name, dense in p.items()}, h,
        Jet(*(v[..., f0:f1] for v in env)), nspins)
        for f0, f1 in orbital_head.harmonic_ranges(FLUX + 1)]
    for name, got, want in zip(Jet._fields, (sum(f) for f in zip(*parts)), whole):
        assert float((got - want).abs().max()) <= 1e-13 * float(want.abs().max()), name
