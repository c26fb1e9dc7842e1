"""The orbital head's jet in one pass (``ops/orbital_head.py``) against the
materialised head: the whole feature jet, then the envelope contraction.

On the CPU, in float64: the plain version (the kernel's sums in its order,
the envelope's structurally zero tangents skipped) against the materialised
head (:func:`materialised`: the complex projection, then ``fwdlap.bilinear``
with an ``einsum``), on every field of the jet, at N=6 (2Q=15) and N=10
(2Q=27), 1 and 16 determinants, lean (E=1) and L^2 (E=3), with a bias, one
and two spin sectors; the sparse orbitals' head composed into a full head
(``networks/fwdlap.py:full_head``) against the materialised sparse head
(eight features lifted by ``lll_weight``); the kernel's column layout (real
and imaginary parts interleaved, pairs padded and tiled, the TF32 split)
against the complex kernel; the sum over harmonic ranges that the kernel
takes past a column tile's harmonics; and the routing: ``kernels=True``
takes ``orbital_matrices_jet``, ``kernels=False`` the plain version, for
full and sparse orbitals, each the materialised head.

On a card (marked ``cuda``, skipped elsewhere): the kernel against its plain
version in float64 at the four configurations' shapes and batch 3360 (N=14
at 2Q=65 in two harmonic ranges, through the epilogue's runtime-stride
loop), and with composed sparse heads; ``psiformer_logpsi_jet`` with the
kernel's head and with the plain version's, both against float64, at the
16-determinant shape and at N=14, 2Q=65; at 65 and 131 harmonics, more than
a column tile holds, the kernel in harmonic ranges, alone and inside
``psiformer_logpsi_jet``; the launch count, ``orbitals.fused`` and
``orbitals.range`` of one local energy.  Run them on the card with

    python -m pytest tests/test_torch_orbital_head.py -m cuda --noconftest
"""

from __future__ import annotations

import copy
import dataclasses
import math
from types import SimpleNamespace

import pytest
import torch

from deephall_tpu_torch import config, hamiltonian, tracing
from deephall_tpu_torch.config import OrbitalType
from deephall_tpu_torch.networks import fwdlap as network_jet
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import fwdlap, orbital_head
from deephall_tpu_torch.ops.fwdlap import Jet
from deephall_tpu_torch.ops.jet_attention import tf32_round
from deephall_tpu_torch.weights import init_params, param_tree

torch.set_num_threads(2)

# On the card: the kernel's three TF32 products and float32 sums against the
# plain version in float64, relative to each field's largest value.  The
# attention's GEMMs are held to 2e-5 the same way (tests/test_torch_kernels_cuda.py).
KERNEL_TOL = 2e-5
# End to end, log psi's jet with the kernel's head and with the plain
# version's, both in float32, each against float64: the kernel no farther
# from it than this many times the plain version, field by field (relative
# to each field's largest value), as phase ``train`` of chip_smoke.py holds
# the kernel path's observables to 1.5 times the plain path's distance.
END_TO_END_FACTOR = 2.0
# Two float32 evaluations of log psi's jet at N=3, 2Q=64, on the card and on
# the CPU, in other summation orders: each field within this of its largest
# value.  The CPU's lies within 7.2e-5 of float64 on these walkers (the
# Laplacian; 3.4e-5 the tangents), so two such are within twice that.
CARD_TO_CPU_TOL = 2e-4


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


def featured(p, h, nspins) -> Jet:
    """The head's complex features ``[*B, N, F, ne, nd]``, each spin
    sector's electrons through its real and imaginary ``DenseGeneral``."""
    sectors, index, lo = [], 0, 0
    for n in nspins:
        if not n:
            continue
        wr, wi = p[f"DenseGeneral_{index}"], p[f"DenseGeneral_{index + 1}"]
        kernel = torch.complex(wr["kernel"], wi["kernel"])
        sectors.append(fwdlap.linear(
            lambda v, rows=slice(lo, lo + n), k=kernel: torch.einsum(
                "...nd,dfek->...nfek", v[..., rows, :].to(k.dtype), k),
            h, bias=torch.complex(wr["bias"], wi["bias"])))
        index, lo = index + 2, lo + n
    return Jet(*(torch.cat(parts, dim=-4) for parts in zip(*sectors)))


def contracted(orbitals: Jet, env: Jet) -> Jet:
    """The feature jet contracted with the envelope's over the harmonics, as
    the orbital matrices ``[*B, nd, N, ne]``."""
    out = fwdlap.bilinear(
        lambda o, e: torch.einsum("...nfed,...nf->...ned", o, e), orbitals, env)
    return fwdlap.linear(lambda v: torch.movedim(v, -1, -3), out)


def materialised(p, h, env, nspins) -> Jet:
    """The full head with its whole feature jet made, then contracted."""
    return contracted(featured(p, h, nspins), env)


def materialised_sparse(p, lll, h, env, nspins) -> Jet:
    """The sparse head so: eight features a (sector, electron, determinant),
    lifted to the harmonics by the real ``lll_weight`` (its bias added to the
    primal), then contracted."""
    orbitals = fwdlap.linear(lambda v: torch.movedim(v, -3, -1) @ lll["kernel"].to(v.dtype),
                             featured(p, h, nspins), bias=lll["bias"])
    return contracted(fwdlap.linear(lambda v: torch.movedim(v, -1, -3), orbitals), env)


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


def sparse_params(gen, depth, flux, nelec, ndet, sectors, dtype=torch.float64, device="cpu"):
    """Random sparse head weights: eight features a pair and ``lll_weight``."""
    p = head_params(gen, depth, 8, nelec, ndet, sectors, dtype, device)
    lll = {"kernel": (8 ** -0.5 * torch.randn(8, flux + 1, generator=gen, dtype=dtype)).to(device),
           "bias": (0.1 * torch.randn(flux + 1, generator=gen, dtype=dtype)).to(device)}
    return p, lll


def composed(p, lll) -> dict:
    """``networks/fwdlap.py:full_head`` of a sparse head."""
    model = SimpleNamespace(orbital_type=OrbitalType.sparse)
    return network_jet.full_head(model, {"featured_orbitals": p, "lll_weight": lll})


# (nspins, 2Q, determinants, extras): the sparse head, one and two spin
# sectors, 1 to 16 determinants, lean and L^2.
SPARSE_CASES = [((3, 0), 6, 2, 1), ((3, 0), 6, 2, 3), ((3, 2), 8, 2, 3), ((4, 0), 9, 3, 1),
                ((2, 2), 5, 1, 1), ((6, 0), 15, 16, 1), ((6, 0), 15, 16, 3)]


@pytest.mark.parametrize("nspins,flux,ndet,extras", SPARSE_CASES)
def test_the_sparse_head_is_a_full_head(nspins, flux, ndet, extras):
    """The sparse head's weights composed with ``lll_weight`` into a full
    head's, through the plain version, against the materialised sparse head,
    on every field of the jet in float64."""
    gen = torch.Generator().manual_seed(sum(nspins) * 100 + flux + ndet + extras)
    nelec, depth = sum(nspins), 32
    p, lll = sparse_params(gen, depth, flux, nelec, ndet, sum(1 for n in nspins if n))
    h, env = jets(gen, 3, nelec, flux, depth, extras)
    got = orbital_head.orbital_matrices_plain(composed(p, lll), h, env, nspins)
    want = materialised_sparse(p, lll, h, env, nspins)
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


@pytest.mark.parametrize("orbital", ["full", "sparse"])
@pytest.mark.parametrize("kernels", [True, False])
def test_the_routes(monkeypatch, orbital, kernels):
    """Full and sparse orbitals alike (the sparse head composed into a full
    one) take ``orbital_matrices_jet`` through the kernels' wrappers, once,
    and its plain version with ``kernels=False``; either gives the
    materialised head of the model's own parameters (for the sparse head,
    :func:`materialised_sparse`) on the tower's and the envelope's jets.  On
    the CPU nothing counts as ``orbitals.fused``: no kernel ran."""
    cfg = small_config(orbital)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(3))
    calls = []

    def spy(name):
        real = getattr(orbital_head, name)

        def call(*args):
            out = real(*args)
            calls.append((name, args, out))
            return out

        monkeypatch.setattr(orbital_head, name, call)

    spy("orbital_matrices_jet")
    spy("orbital_matrices_plain")
    gen = torch.Generator().manual_seed(4)
    data = torch.stack([torch.acos(2 * torch.rand(4, 3, generator=gen) - 1),
                        2 * math.pi * torch.rand(4, 3, generator=gen)], dim=-1)
    with torch.no_grad(), tracing.block(1, "cpu"):
        network_jet.psiformer_logpsi_jet(model, data, compute_l2=True, kernels=kernels)
    # On the CPU the wrapper calls the plain version in turn.
    assert [name for name, _, _ in calls] == (
        ["orbital_matrices_plain", "orbital_matrices_jet"] if kernels
        else ["orbital_matrices_plain"])
    assert tracing.blocks()[-1].counts == {}
    _, (_, h, env, nspins), got = calls[-1]
    params = param_tree(model)["Orbitals_0"]
    with torch.no_grad():
        want = (materialised(params["featured_orbitals"], h, env, nspins) if orbital == "full"
                else materialised_sparse(params["featured_orbitals"], params["lll_weight"],
                                         h, env, nspins))
    for name, a, b in zip(Jet._fields, got, want):
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-4 * float(b.abs().max())), name


@pytest.mark.parametrize("harmonics,ranges", [
    (16, [(0, 16)]), (64, [(0, 64)]), (65, [(0, 32), (32, 65)]),
    (131, [(0, 43), (43, 87), (87, 131)]),
])
def test_harmonic_ranges(harmonics, ranges):
    assert orbital_head.harmonic_ranges(harmonics) == ranges


@pytest.mark.parametrize("nspins,flux,ndet,extras", [((3, 0), 64, 2, 3), ((2, 1), 130, 1, 1)])
def test_the_harmonics_add_up(nspins, flux, ndet, extras):
    """Where a column tile does not hold a pair's harmonics, the kernel takes
    :func:`orbital_head.harmonic_ranges` one launch each and adds their
    matrices: every field of the jet, bias included, is that sum (the plain
    version on each range, float64)."""
    gen = torch.Generator().manual_seed(flux + extras)
    nelec, depth = sum(nspins), 32
    p = head_params(gen, depth, flux + 1, nelec, ndet, sum(1 for n in nspins if n))
    h, env = jets(gen, 3, nelec, flux, depth, extras)
    ranges = orbital_head.harmonic_ranges(flux + 1)
    assert len(ranges) > 1
    parts = [orbital_head.orbital_matrices_plain(
        {name: orbital_head.harmonic_slice(dense, f0, f1) for name, dense in p.items()}, h,
        Jet(*(v[..., f0:f1] for v in env)), nspins) for f0, f1 in ranges]
    got = Jet(*(sum(fields) for fields in zip(*parts)))
    errors = relative_errors(got, orbital_head.orbital_matrices_plain(p, h, env, nspins))
    assert max(errors.values()) < 1e-13, errors


# --- on the card ---------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


# (N, 2Q, determinants, extras) of the benchmark's configurations and jet
# modes; N=14 at 2Q=65 takes two harmonic ranges.
CARD_SHAPES = [(6, 15, 1, 3), (6, 15, 1, 1), (10, 27, 1, 1), (10, 27, 16, 1), (14, 65, 1, 3),
               (14, 65, 1, 1)]


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
    want = orbital_head.orbital_matrices_plain(
        in_float64(p), Jet(*(v.double() for v in h)), Jet(*(v.to(torch.complex128) for v in env)),
        (nelec, 0))
    errors = relative_errors(got, want)
    assert max(errors.values()) <= KERNEL_TOL, errors


def in_float64(p: dict) -> dict:
    return {k: {leaf: v.double() for leaf, v in d.items()} for k, d in p.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("nelec,flux", [(6, 15), (10, 27)])
def test_a_sparse_head_through_the_kernel(device, nelec, flux):
    """Batch 3360, D = 256, 1 determinant, lean: a sparse head composed into a
    full one (``full_head``) through the kernel in float32, against the plain
    version in float64, every field within :data:`KERNEL_TOL`."""
    gen = torch.Generator().manual_seed(nelec + flux)
    p, lll = sparse_params(gen, 256, flux, nelec, 1, 1, dtype=torch.float32, device=device)
    head = composed(p, lll)
    h, env = jets(gen, 3360, nelec, flux, 256, 1, dtype=torch.float32, device=device)
    before = orbital_head.orbital_matrices_jet.launches
    got = orbital_head.orbital_matrices_jet(head, h, env, (nelec, 0))
    torch.cuda.synchronize()
    assert orbital_head.orbital_matrices_jet.launches == before + 1
    want = orbital_head.orbital_matrices_plain(
        in_float64(head), Jet(*(v.double() for v in h)),
        Jet(*(v.to(torch.complex128) for v in env)), (nelec, 0))
    errors = relative_errors(got, want)
    assert max(errors.values()) <= KERNEL_TOL, errors


@pytest.mark.cuda
@pytest.mark.parametrize("nspins,flux,ndet,extras", [((3, 0), 64, 16, 1), ((2, 1), 130, 2, 3)])
def test_the_kernel_in_harmonic_ranges(device, nspins, flux, ndet, extras):
    """65 and 131 harmonics, more than a column tile holds: two and three
    launches of the kernel added, batch 3360, D = 256, against the plain
    version in float64, every field within :data:`KERNEL_TOL`."""
    gen = torch.Generator().manual_seed(flux + extras)
    nelec = sum(nspins)
    p = head_params(gen, 256, flux + 1, nelec, ndet, sum(1 for n in nspins if n),
                    dtype=torch.float32, device=device)
    h, env = jets(gen, 3360, nelec, flux, 256, extras, dtype=torch.float32, device=device)
    before = orbital_head.orbital_matrices_jet.launches
    got = orbital_head.orbital_matrices_jet(p, h, env, nspins)
    torch.cuda.synchronize()
    assert orbital_head.orbital_matrices_jet.launches == before + 1
    want = orbital_head.orbital_matrices_plain(
        in_float64(p), Jet(*(v.double() for v in h)), Jet(*(v.to(torch.complex128) for v in env)),
        nspins)
    errors = relative_errors(got, want)
    assert max(errors.values()) <= KERNEL_TOL, errors


@pytest.mark.cuda
def test_more_harmonics_than_a_tile_holds(device):
    """N=3 at 2Q=64: 65 harmonics, more than a column tile holds, inside
    ``psiformer_logpsi_jet`` through every other kernel: the head takes the
    kernel in two harmonic ranges, one wrapper call counted as
    ``orbitals.fused`` and two launches as ``orbitals.range``, and log psi's
    jet lies within :data:`CARD_TO_CPU_TOL` of the same model's on the CPU."""
    raw = {"batch_size": 64, "system": {"nspins": [3, 0], "flux": 64},
           "network": {"psiformer": {"num_layers": 1}}}
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(21))
    gen = torch.Generator().manual_seed(22)
    data = torch.stack([torch.acos(2 * torch.rand(64, 3, generator=gen) - 1),
                        2 * math.pi * torch.rand(64, 3, generator=gen)], dim=-1)
    with torch.no_grad():
        want = network_jet.psiformer_logpsi_jet(model, data, compute_l2=True)
        card = copy.deepcopy(model).to(device)
        before = orbital_head.orbital_matrices_jet.launches
        with tracing.block(1, device):
            got = network_jet.psiformer_logpsi_jet(card, data.to(device), compute_l2=True)
    assert orbital_head.orbital_matrices_jet.launches == before + 1
    assert tracing.blocks()[-1].counts.get("orbitals.fused") == 1
    assert tracing.blocks()[-1].counts.get("orbitals.range") == 2
    errors = relative_errors(Jet(*(v.cpu() for v in got)), want)
    assert max(errors.values()) <= CARD_TO_CPU_TOL, errors


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
    through every kernel with the kernel's head, and with the plain version's
    head in float32 on the card (every other kernel the same), both against
    ``kernels=False`` in float64."""
    _, model, data = l4k16(device, 1680)
    with torch.no_grad():
        want = network_jet.psiformer_logpsi_jet(copy.deepcopy(model).double(), data.double(),
                                                kernels=False)
        got = network_jet.psiformer_logpsi_jet(model, data, kernels=True)
        monkeypatch.setattr(orbital_head, "orbital_matrices_jet",
                            orbital_head.orbital_matrices_plain)
        plain = network_jet.psiformer_logpsi_jet(model, data, kernels=True)
    kernel_errors, plain_errors = relative_errors(got, want), relative_errors(plain, want)
    for name in Jet._fields:
        assert kernel_errors[name] <= END_TO_END_FACTOR * plain_errors[name], (
            kernel_errors, plain_errors)


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
    assert tracing.blocks()[-1].counts == {"orbitals.fused": 1, "orbitals.range": 1}
    assert torch.isfinite(energy).all()


def nu_one_fifth(device, batch: int):
    """The nu=1/5 configuration's model at N=14, 2Q=65 (fresh weights, seed
    23) and walkers, 14 of them within 1e-3 of a pole."""
    raw = {"batch_size": batch, "system": {"nspins": [14, 0], "flux": 65}}
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(23))
    gen = torch.Generator().manual_seed(24)
    theta = torch.acos(2 * torch.rand(batch, 14, generator=gen) - 1)
    theta[:7, 0] = torch.linspace(1e-4, 1e-3, 7)
    theta[7:14, 0] = math.pi - torch.linspace(1e-4, 1e-3, 7)
    data = torch.stack([theta, 2 * math.pi * torch.rand(batch, 14, generator=gen)], dim=-1)
    return cfg, model.to(device), data.to(device)


@pytest.mark.cuda
def test_the_nu_one_fifth_system_through_the_kernels(device, monkeypatch):
    """N=14 at 2Q=65, batch 336, L^2 jet: log psi's jet through every kernel
    (the head in two harmonic-range passes through the epilogue's
    runtime-stride loop, the T=14 attention and LayerNorm) and with the
    plain version's head in float32, both against ``kernels=False`` in
    float64, as :func:`test_log_psi_jet_through_the_kernel`; a local energy
    counts one ``orbitals.fused`` and two ``orbitals.range``."""
    cfg, model, data = nu_one_fifth(device, 336)
    with torch.no_grad():
        want = network_jet.psiformer_logpsi_jet(copy.deepcopy(model).double(), data.double(),
                                                compute_l2=True, kernels=False)
        got = network_jet.psiformer_logpsi_jet(model, data, compute_l2=True, kernels=True)
        e_l = hamiltonian.forward_laplacian_local_energy(model, cfg.system)
        with tracing.block(1, device):
            energy, _ = e_l(data)
        monkeypatch.setattr(orbital_head, "orbital_matrices_jet",
                            orbital_head.orbital_matrices_plain)
        plain = network_jet.psiformer_logpsi_jet(model, data, compute_l2=True, kernels=True)
    assert tracing.blocks()[-1].counts == {"orbitals.fused": 1, "orbitals.range": 2}
    assert torch.isfinite(energy).all()
    kernel_errors, plain_errors = relative_errors(got, want), relative_errors(plain, want)
    for name in Jet._fields:
        assert kernel_errors[name] <= END_TO_END_FACTOR * plain_errors[name], (
            kernel_errors, plain_errors)
