"""The orbital head's jet in one pass (``ops/orbital_head.py``) against the
materialised route it replaces.

On the CPU, in float64: the plain version (the kernel's sums in its order,
the envelope's structurally zero tangents skipped) against
``networks/fwdlap.py:_featured_orbitals`` followed by ``fwdlap.bilinear``
with an ``einsum``, on every field of the jet, at N=6 (2Q=15) and N=10
(2Q=27), 1 and 16 determinants, lean (E=1) and L^2 (E=3), with a bias, one
and two spin sectors; the kernel's column layout (real and imaginary parts
interleaved, pairs padded and tiled, the TF32 split) against the complex
kernel; and the routing: the full orbitals take the fused route, the sparse
orbitals and ``kernels=False`` the materialised one.

On a card (marked ``cuda``, skipped elsewhere): the kernel against its plain
version in float64 at the three configurations' shapes and batch 3360;
``psiformer_logpsi_jet`` with the fused head and with the materialised one,
both against float64, at the 16-determinant shape; the launch count and
``orbitals.fused`` of one local energy.  Run them on the card with

    python -m pytest tests/test_torch_orbital_head.py -m cuda --noconftest
"""

from __future__ import annotations

import copy
import dataclasses
import math

import pytest
import torch

from deephall_tpu_torch import config, hamiltonian, tracing
from deephall_tpu_torch.networks import fwdlap as network_jet
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import fwdlap, orbital_head
from deephall_tpu_torch.ops.fwdlap import Jet
from deephall_tpu_torch.ops.jet_attention import tf32_round
from deephall_tpu_torch.weights import init_params

torch.set_num_threads(2)

# On the card: the kernel's three TF32 products and float32 sums against the
# plain version in float64, relative to each field's largest value.  The
# attention's GEMMs are held to 2e-5 the same way (tests/test_torch_kernels_cuda.py).
KERNEL_TOL = 2e-5
# End to end, log psi's jet with the fused head and with the materialised head
# it replaced, both in float32, each against float64: the fused route no
# farther from it than this many times the replaced one, field by field
# (relative to each field's largest value), as phase ``train`` of
# chip_smoke.py holds the kernel path's observables to 1.5 times the plain
# path's distance.
END_TO_END_FACTOR = 2.0


def head_params(gen, depth, harmonics, nelec, ndet, sectors, dtype=torch.float64, device="cpu"):
    """Random head weights and biases of ``sectors`` spin sectors, scaled as
    flax's initialiser scales them."""
    def normal(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, dtype=dtype).to(device)

    return {f"DenseGeneral_{i}": {"kernel": normal(depth, harmonics, nelec, ndet,
                                                   scale=depth ** -0.5),
                                  "bias": normal(harmonics, nelec, ndet, scale=0.1)}
            for i in range(2 * sectors)}


def jets(gen, batch, nelec, flux, depth, extras, dtype=torch.float64, device="cpu"):
    """A random tower jet and the envelope's jet at random walkers."""
    c = 2 * nelec + extras

    def normal(*shape):
        return torch.randn(shape, generator=gen, dtype=dtype).to(device)

    h = Jet(normal(batch, nelec, depth), normal(c, batch, nelec, depth),
            normal(batch, nelec, depth), normal(extras, batch, nelec, depth))
    theta = torch.acos(2 * torch.rand(batch, nelec, generator=gen, dtype=dtype) - 1)
    phi = 2 * math.pi * torch.rand(batch, nelec, generator=gen, dtype=dtype)
    data = torch.stack([theta, phi], dim=-1).to(device)
    seeds = fwdlap.electron_seeds(data, extras == 3)
    env = fwdlap.jet_of_fn(network_jet.envelope_fn(flux), data, seeds, extras)
    return h, env


def materialised(p, h, env, nspins) -> Jet:
    """The route the kernel replaces: the feature jet, then ``fwdlap.bilinear``."""
    orbitals = network_jet._featured_orbitals(p, h, nspins)
    contracted = fwdlap.bilinear(
        lambda o, e: torch.einsum("...nfed,...nf->...ned", o, e), orbitals, env)
    return fwdlap.linear(lambda v: torch.movedim(v, -1, -3), contracted)


def relative_errors(got: Jet, want: Jet) -> dict:
    out = {}
    for name, a, b in zip(Jet._fields, got, want):
        assert a.shape == b.shape, name
        out[name] = float((a - b).abs().max() / b.abs().max().clamp_min(1e-300))
    return out


# (nspins, 2Q, determinants, extras): N=6 and N=10 at nu = 1/3, 1 and 16
# determinants, lean and L^2; then two spin sectors.
CASES = [((6, 0), 15, 1, 1), ((6, 0), 15, 1, 3), ((6, 0), 15, 16, 1), ((6, 0), 15, 16, 3),
         ((10, 0), 27, 1, 1), ((10, 0), 27, 1, 3), ((10, 0), 27, 16, 1), ((10, 0), 27, 16, 3),
         ((3, 3), 15, 2, 3), ((4, 2), 9, 1, 1)]


@pytest.mark.parametrize("nspins,flux,ndet,extras", CASES)
def test_the_plain_version_is_the_materialised_route(nspins, flux, ndet, extras):
    """Every field of the jet, float64: what the kernel skips is exactly zero."""
    gen = torch.Generator().manual_seed(sum(nspins) * 100 + flux + ndet + extras)
    nelec, depth = sum(nspins), 32
    p = head_params(gen, depth, flux + 1, nelec, ndet, sum(1 for n in nspins if n))
    h, env = jets(gen, 3, nelec, flux, depth, extras)
    got = orbital_head.orbital_matrices_jet(p, h, env, nspins)
    want = materialised(p, h, env, nspins)
    errors = relative_errors(got, want)
    assert max(errors.values()) < 1e-13, errors


def test_batch_axes_are_flattened_and_restored():
    gen = torch.Generator().manual_seed(5)
    p = head_params(gen, 32, 8, 4, 2, 1)
    h, env = jets(gen, 6, 4, 7, 32, 1)

    def split(t: Jet) -> Jet:
        return Jet(t.x.unflatten(0, (2, 3)), t.j.unflatten(1, (2, 3)),
                   t.l.unflatten(0, (2, 3)), t.d.unflatten(1, (2, 3)))

    got = orbital_head.orbital_matrices_jet(p, split(h), split(env), (4, 0))
    want = split(materialised(p, h, env, (4, 0)))
    assert max(relative_errors(got, want).values()) < 1e-13


@pytest.mark.parametrize("harmonics,pairs,plan", [
    (28, 160, (56, 2, 112, 80)),  # N=10, 2Q=27, 16 determinants
    (28, 10, (56, 2, 112, 5)),  # N=10, 1 determinant
    (16, 6, (32, 3, 96, 2)),  # N=6, 2Q=15, 1 determinant
    (16, 96, (32, 4, 128, 24)),  # N=6, 16 determinants
    (5, 3, (16, 3, 64, 1)),  # N=3, 2Q=4
    (34, 12, (72, 1, 96, 12)),  # N=12, 2Q=33: one pair a tile, padded
    (64, 1, (128, 1, 128, 1)),
])
def test_column_plan(harmonics, pairs, plan):
    assert tuple(orbital_head.column_plan(harmonics, pairs)) == plan


@pytest.mark.parametrize("harmonics", [0, 65])
def test_column_plan_refuses_what_no_tile_holds(harmonics):
    with pytest.raises(ValueError, match="harmonics"):
        orbital_head.column_plan(harmonics, 4)


@pytest.mark.parametrize("harmonics,nelec,ndet", [(28, 10, 16), (16, 6, 1), (5, 3, 2)])
def test_head_columns_against_the_complex_kernel(harmonics, nelec, ndet):
    """The kernel's real columns, interleaved, padded and split into TF32
    halves, give the complex kernel's features: pair ``g = k N + n`` in
    column tile ``g // per_tile``, harmonic ``f`` in columns ``2f, 2f + 1``."""
    gen = torch.Generator().manual_seed(harmonics)
    depth = 64
    p = head_params(gen, depth, harmonics, nelec, ndet, 1, dtype=torch.float32)
    wr, wi = p["DenseGeneral_0"], p["DenseGeneral_1"]
    cols = orbital_head.split_columns(wr, wi)
    plan = cols.plan
    assert cols.hi.shape == cols.lo.shape == (plan.tiles * plan.width, depth)
    for half in (cols.hi, cols.lo):  # each exactly a TF32 number
        assert torch.equal(tf32_round(half), half)
    w = (cols.hi.double() + cols.lo.double()).t()  # [D, tiles * width]
    kernel = torch.complex(wr["kernel"], wi["kernel"]).to(torch.complex128)
    bias = torch.complex(wr["bias"], wi["bias"]).to(torch.complex128)
    a = torch.randn(5, depth, generator=gen, dtype=torch.float64)
    want = torch.einsum("md,dfnk->mfnk", a.to(torch.complex128), kernel)
    real = a @ w
    stride, per_tile, width = plan.stride, plan.per_tile, plan.width
    used = torch.zeros(plan.tiles * width, dtype=torch.bool)
    for k in range(ndet):
        for n in range(nelec):
            g = k * nelec + n
            col = (g // per_tile) * width + (g % per_tile) * stride
            got = torch.complex(real[:, col : col + 2 * harmonics : 2],
                                real[:, col + 1 : col + 2 * harmonics : 2])
            # hi + lo holds the float32 weight to 2^-22 of itself.
            assert torch.allclose(got, want[:, :, n, k], rtol=0, atol=1e-6 * want.abs().max())
            got_bias = torch.complex(cols.bias[col : col + 2 * harmonics : 2],
                                     cols.bias[col + 1 : col + 2 * harmonics : 2])
            assert torch.equal(got_bias.to(torch.complex128), bias[:, n, k])
            used[col : col + 2 * harmonics] = True
    assert not w[:, ~used].any() and not cols.bias[~used].any()  # the padding is zero


def small_config(orbital: str, ndet: int = 2):
    raw = {"batch_size": 4, "system": {"nspins": [3, 0], "flux": 6},
           "network": {"orbital": orbital,
                       "psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 16,
                                     "determinants": ndet}}}
    return config.Config.from_dict(raw)


@pytest.mark.parametrize("orbital,kernels,fused", [
    ("full", True, True), ("full", False, False), ("sparse", True, False),
    ("sparse", False, False)])
def test_the_routes(monkeypatch, orbital, kernels, fused):
    """Full orbitals through the kernels' wrappers take the fused route; the
    sparse orbitals (a different layer: eight features lifted by
    ``lll_weight``) and ``kernels=False`` the materialised one.  On the CPU
    nothing counts as ``orbitals.fused``: no kernel ran."""
    cfg = small_config(orbital)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(3))
    calls = []
    real = orbital_head.orbital_matrices_jet

    def spy(*args):
        calls.append(1)
        return real(*args)

    monkeypatch.setattr(orbital_head, "orbital_matrices_jet", spy)
    gen = torch.Generator().manual_seed(4)
    data = torch.stack([torch.acos(2 * torch.rand(4, 3, generator=gen) - 1),
                        2 * math.pi * torch.rand(4, 3, generator=gen)], dim=-1)
    with torch.no_grad(), tracing.block(1, "cpu"):
        out = network_jet.psiformer_logpsi_jet(model, data, compute_l2=True, kernels=kernels)
    assert len(calls) == int(fused)
    assert tracing.blocks()[-1].counts == {}
    with torch.no_grad():
        other = network_jet.psiformer_logpsi_jet(model, data, compute_l2=True,
                                                 kernels=not kernels)
    for name, a, b in zip(Jet._fields, out, other):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max())), name


@pytest.mark.parametrize("nelec,ndet,extras,per_walker", [
    (10, 16, 1, (24 + 8) * 16 * 100 * 8),  # the 16-determinant cell: 1.38 GB, one group
    (6, 1, 3, (20 + 14) * 36 * 8),  # N = 6 with L^2
])
def test_the_fused_route_takes_one_group(nelec, ndet, extras, per_walker):
    planes = 2 * nelec + 2 * extras + 2
    assert orbital_head.walker_bytes(planes, extras, nelec, ndet, 4) == per_walker
    assert len(network_jet.orbital_groups(3360, per_walker)) == 1


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (N, 2Q, determinants, extras) of the benchmark's configurations and jet modes.
CARD_SHAPES = [(6, 15, 1, 3), (6, 15, 1, 1), (10, 27, 1, 1), (10, 27, 16, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("nelec,flux,ndet,extras", CARD_SHAPES)
def test_the_kernel_against_its_plain_version(device, nelec, flux, ndet, extras):
    """Batch 3360, D = 256: the kernel in float32 against the plain version
    in float64 on the same float32 inputs, every field within
    :data:`KERNEL_TOL` of its largest value."""
    gen = torch.Generator().manual_seed(nelec + ndet + extras)
    p = head_params(gen, 256, flux + 1, nelec, ndet, 1, dtype=torch.float32, device=device)
    h, env = jets(gen, 3360, nelec, flux, 256, extras, dtype=torch.float32, device=device)
    before = orbital_head.orbital_matrices_jet.launches
    got = orbital_head.orbital_matrices_jet(p, h, env, (nelec, 0))
    torch.cuda.synchronize()
    assert orbital_head.orbital_matrices_jet.launches == before + 1
    p64 = {k: {leaf: v.double() for leaf, v in d.items()} for k, d in p.items()}
    want = orbital_head.orbital_matrices_plain(
        p64, Jet(*(v.double() for v in h)), Jet(*(v.to(torch.complex128) for v in env)),
        (nelec, 0))
    errors = relative_errors(got, want)
    assert max(errors.values()) <= KERNEL_TOL, errors


def l4k16(device, batch: int):
    """The 16-determinant configuration's model (fresh weights, seed 19) and walkers."""
    raw = {"batch_size": batch, "system": {"nspins": [10, 0], "flux": 27},
           "network": {"psiformer": {"num_layers": 4, "determinants": 16}}}
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(19))
    gen = torch.Generator().manual_seed(20)
    data = torch.stack([torch.acos(2 * torch.rand(batch, 10, generator=gen) - 1),
                        2 * math.pi * torch.rand(batch, 10, generator=gen)], dim=-1)
    return cfg, model.to(device), data.to(device)


@pytest.mark.cuda
def test_log_psi_jet_through_the_kernel(device, monkeypatch):
    """The 16-determinant Psiformer at N=10, 2Q=27, batch 1680: log psi's jet
    through every kernel with the fused head, and with the materialised head
    it replaced (every other kernel the same), both against ``kernels=False``
    in float64."""
    _, model, data = l4k16(device, 1680)
    with torch.no_grad():
        want = network_jet.psiformer_logpsi_jet(copy.deepcopy(model).double(), data.double(),
                                                kernels=False)
        got = network_jet.psiformer_logpsi_jet(model, data, kernels=True)
        fused = network_jet._orbital_matrices
        monkeypatch.setattr(network_jet, "_orbital_matrices",
                            lambda model, p, piece, _: fused(model, p, piece, False))
        replaced = network_jet.psiformer_logpsi_jet(model, data, kernels=True)
    kernel_errors, replaced_errors = relative_errors(got, want), relative_errors(replaced, want)
    for name in Jet._fields:
        assert kernel_errors[name] <= END_TO_END_FACTOR * replaced_errors[name], (
            kernel_errors, replaced_errors)


@pytest.mark.cuda
@pytest.mark.parametrize("ndet", [1, 16])
def test_one_launch_and_one_count_a_local_energy(device, ndet):
    cfg, model, data = l4k16(device, 336)
    if ndet != 16:
        network = dataclasses.replace(
            cfg.network, psiformer=dataclasses.replace(cfg.network.psiformer, determinants=ndet))
        model = make_network(cfg.system, network)
        init_params(model, torch.Generator().manual_seed(19))
        model = model.to(device)
    e_l = hamiltonian.forward_laplacian_local_energy(model, cfg.system)
    before = orbital_head.orbital_matrices_jet.launches
    with torch.no_grad(), tracing.block(1, device):
        energy, _ = e_l(data)
    assert orbital_head.orbital_matrices_jet.launches == before + 1
    assert tracing.blocks()[-1].counts == {"orbitals.fused": 1}
    assert torch.isfinite(energy).all()
