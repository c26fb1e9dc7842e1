"""The published Psiformer's depth and determinants (4 layers, 16 determinants)
in the port, against the benchmark's plain reference.

``benchmark/reference/psiformer.py`` is plain PyTorch with its own LU,
generic in layers and determinants; ``energy`` takes the local energy by the
full Hessian through autograd, ``vmc`` the clipped gradient, the KFAC
capture and one KFAC step.  The port (``deephall_tpu_torch``) runs its own
route to each: ``Psiformer.forward`` with ``signed_logsumdet``, the
forward-Laplacian jet with its plain kernels, ``loss.gradient_and_capture``
and ``optimizers.kfac``.  Both run in float64 on seeded random weights, each
parameter moved off flax's initial values (zero biases, unit scales), at
small widths (2 heads x 8), N=4, 2Q=9, 8 walkers, so that a gap is a
difference of the mathematics and not of rounding (:data:`RTOL`).
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
from deephall_tpu_torch.networks import make_network  # noqa: E402
from deephall_tpu_torch.optimizers import kfac  # noqa: E402
from deephall_tpu_torch.types import KfacState  # noqa: E402
from deephall_tpu_torch.weights import init_params  # noqa: E402

torch.set_num_threads(2)

NSPINS, FLUX, LAYERS, HEADS, DETS, BATCH = (4, 0), 9, 4, 2, 16, 8
HEAD_BLOCKS = ("Orbitals_0/featured_orbitals/DenseGeneral_0",
               "Orbitals_0/featured_orbitals/DenseGeneral_1")
KFAC = {"rate": 0.05, "decay": 1.0, "delay": 2000.0, "damping": 1e-3, "curvature_ema": 0.95,
        "norm_constraint": 1e-3}
# float64 on both sides, but the port's envelope norms sqrt(C(2Q, k)) are
# float32 constants whatever the walkers' dtype (``blocks.envelope_exponents``),
# off by up to 6e-8 of each: the orbital matrices differ by 3.5e-8 here, and
# the log psi by 7e-8.  1e-6 of a value's scale is some 15 times that; a
# wrong term of the jet, the gradient or the step is off by far more.
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
    init_params(model, torch.Generator().manual_seed(19))
    moves = torch.Generator().manual_seed(20)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=moves))
    model = model.double()
    # The module's names and shapes are the stored run's (``weights``).
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    rng = np.random.default_rng(21)
    theta = np.arccos(rng.uniform(-0.95, 0.95, (BATCH, sum(NSPINS))))
    phi = rng.uniform(-np.pi, np.pi, (BATCH, sum(NSPINS)))
    x = torch.from_numpy(np.stack([theta, phi], -1))
    spec = psiformer.Spec(NSPINS, FLUX, HEADS, LAYERS)
    return cfg, model, params, spec, x


def test_the_network_is_the_published_depth_and_determinants(setup):
    _, model, params, _, _ = setup
    assert model.num_layers == LAYERS and model.ndets == DETS
    kernel = params["Orbitals_0.featured_orbitals.DenseGeneral_0.kernel"]
    assert kernel.numel() == 2 * HEADS * 4 * (FLUX + 1) * sum(NSPINS) * DETS  # D x F


def test_log_psi(setup):
    _, model, params, spec, x = setup
    with torch.no_grad():
        got = model(x)
    want = psiformer.logpsi(params, spec, x)
    assert close(got.real, want.real)
    # the phase modulo 2 pi
    assert close(torch.remainder(got.imag - want.imag + math.pi, 2 * math.pi) - math.pi, 0.0)


@pytest.mark.parametrize("key", ["energy", "kinetic", "potential", "angular_momentum_z",
                                 "angular_momentum_z_square", "angular_momentum_square"])
def test_the_jet_local_energy(setup, key):
    """The forward-Laplacian jet (plain kernels) against the reference's full Hessian."""
    cfg, model, params, spec, x = setup
    with torch.no_grad():
        el, obs = hamiltonian.forward_laplacian_local_energy(model, cfg.system, kernels=False)(x)
    want = energy.observables(lambda y: psiformer.logpsi(params, spec, y), x, FLUX)
    got = el if key == "energy" else obs[key]
    assert close(got, want[key]), (key, got, want[key])


def specs_of(model):
    """KFAC's blocks, found by a float32 forward of a copy (``kfac.discover``)."""
    return kfac.discover(copy.deepcopy(model).float(), sum(NSPINS))


@pytest.fixture(scope="module")
def both_gradients(setup):
    """Each side's clipped energy gradient and KFAC capture from its own local energy."""
    cfg, model, params, spec, x = setup
    with torch.no_grad():
        el, obs = hamiltonian.forward_laplacian_local_energy(model, cfg.system, kernels=False)(x)
    _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, x, el, obs)
    ref_obs = energy.observables(lambda y: psiformer.logpsi(params, spec, y), x, FLUX)
    system = {"compute_l2": True, "dynamic_penalties": False, "l2_adaptive": False,
              "lz_penalty": 0.0, "lz_center": 0.0, "l2_penalty": 0.0, "l2_center": 0.0,
              "overlap_penalty": 1.0}
    _, diff = vmc.stats_and_diff(system, ref_obs)
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
    """The head's Kronecker factors: ``A`` of its inputs with a ones column
    (the bias), ``G`` of the Fisher sensitivities of its outputs, each a mean
    over the rows (walker, electron)."""
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
    """KFAC's first step from the state ``opt_init`` makes (factors and weight
    zero), as the fresh checkpoint of the benchmark stores it."""
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
    assert float(new_state.weight) == pytest.approx(1 - KFAC["curvature_ema"], rel=1e-12)
    for path in HEAD_BLOCKS:
        assert close(new_state.kron[path]["g"], ref_curvature["kron"][path]["g"])
    assert float(info["quadratic_norm"]) == pytest.approx(ref_info["quadratic_norm"], rel=RTOL)
    assert float(info["norm_coefficient"]) == pytest.approx(ref_info["norm_coefficient"], rel=RTOL)
    for name, p in port.items():
        start = params[name]
        change, ref_change = p.reshape(start.shape) - start, ref_params[name] - start
        assert close(change, ref_change, RTOL * float(ref_change.abs().max())), name

