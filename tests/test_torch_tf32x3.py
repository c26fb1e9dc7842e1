"""The three-term TF32 product and the prepared attention weights, on the CPU.

The tensor-core ``jet_gemm`` multiplies operands split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` and sums ``lo*hi + hi*lo + hi*hi`` in float32.  The kernel
itself runs only on a card; here the algorithm is emulated in plain PyTorch
(TF32-representable operands multiply exactly in float32, as in the tensor
cores) and the host half of it (the split of the weights, their layout, the
cache) is tested directly.  Inputs come from numpy seeds.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from deephall_tpu_torch.ops import fwdlap, jet_attention

torch.set_num_threads(2)

K = 256
# The weight scales of the kernel tests (1/sqrt(fan-in)) and of a wide layer.
SCALES = [1 / math.sqrt(K), 1.0, 30.0]


def normal(seed, *shape, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32))


def low_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) & 0x1FFF


@pytest.mark.parametrize("scale", SCALES)
def test_split_halves_are_tf32(scale):
    w = normal(1, 64, 48, scale=scale)
    split = jet_attention.split_weight(w)
    assert split.hi.shape == split.lo.shape == (48, 64) and split.hi.is_contiguous()
    assert torch.equal(split.w, w)
    assert not low_bits(split.hi).any() and not low_bits(split.lo).any()
    # hi + lo reproduces w^T to 2^-21 of each element (lo keeps 11 of w - hi's bits).
    err = (split.hi.double() + split.lo.double() - w.t().double()).abs()
    assert (err <= w.t().double().abs() * 2.0**-21).all()


@pytest.mark.parametrize("scale", SCALES)
def test_rounding_is_to_nearest(scale):
    x = normal(2, 4096, scale=scale)
    r = jet_attention.tf32_round(x)
    # A TF32 neighbour is 2^13 float32 steps away: nearest means at most half of that.
    step = (x.abs().view(torch.int32) & ~0x1FFF).view(torch.float32)
    ulp = ((step.view(torch.int32) + 0x2000).view(torch.float32) - step).double()
    assert ((r.double() - x.double()).abs() <= ulp / 2).all()
    assert torch.equal(jet_attention.tf32_round(r), r)


def test_rounding_ties_go_away_from_zero():
    # 1 + 2^-11 lies halfway between the TF32 neighbours 1 and 1 + 2^-10.
    x = torch.tensor([1 + 2.0**-11, -(1 + 2.0**-11), 1 + 2.0**-12, 1 + 3 * 2.0**-12])
    want = torch.tensor([1 + 2.0**-10, -(1 + 2.0**-10), 1.0, 1 + 2.0**-10])
    assert torch.equal(jet_attention.tf32_round(x), want)


def emulated_products(a: torch.Tensor, w: torch.Tensor):
    """(three-term, one-term) products of ``a [M, K] @ w [K, N]`` as the kernel forms them."""
    split = jet_attention.split_weight(w)
    a_hi = jet_attention.tf32_round(a)
    a_lo = jet_attention.tf32_round(a - a_hi)
    w_hi, w_lo = split.hi.t(), split.lo.t()
    small = a_lo @ w_hi + a_hi @ w_lo
    return small + a_hi @ w_hi, a_hi @ w_hi


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("n", [256, 768])
def test_three_terms_reach_float32_and_one_term_does_not(scale, n):
    a = normal(3, 96, K)
    w = normal(4, K, n, scale=scale)
    exact = a.double() @ w.double()
    largest = exact.abs().max()
    three, one = emulated_products(a, w)
    assert (three.double() - exact).abs().max() <= 2e-6 * largest
    # Why three terms: plain TF32 misses the kernels' gate of 2e-5 by an order of magnitude.
    assert (one.double() - exact).abs().max() > 2e-5 * largest


def attention_params(seed, feat, heads):
    dh = feat // heads
    p = {name: {"kernel": normal(seed + i, feat, heads, dh, scale=1 / math.sqrt(feat)),
                "bias": normal(seed + 10 + i, heads, dh, scale=0.1)}
         for i, name in enumerate(("query", "key", "value"))}
    p["out"] = {"kernel": normal(seed + 20, heads, dh, feat, scale=1 / math.sqrt(feat)),
                "bias": normal(seed + 21, feat, scale=0.1)}
    return p


@pytest.mark.parametrize("feat,heads", [(32, 4), (64, 2)])
def test_prepared_weights_layout(feat, heads):
    p = attention_params(30, feat, heads)
    prepared = jet_attention.prepare_weights(p, heads)
    scale = 1 / math.sqrt(feat // heads)
    q, k, v = (p[n]["kernel"].reshape(feat, feat) for n in ("query", "key", "value"))
    # 1/sqrt(dh) goes into the q columns and the q bias only.
    assert torch.equal(prepared.wqkv.w, torch.cat([q * scale, k, v], dim=1))
    assert torch.equal(prepared.bqkv, torch.cat([p["query"]["bias"].reshape(-1) * scale,
                                                 p["key"]["bias"].reshape(-1),
                                                 p["value"]["bias"].reshape(-1)]))
    assert torch.equal(prepared.wo.w, p["out"]["kernel"].reshape(feat, feat))
    assert torch.equal(prepared.bo, p["out"]["bias"])
    # The halves are [N, K]: K contiguous, as the tensor cores read them.
    assert prepared.wqkv.hi.shape == (3 * feat, feat) and prepared.wo.lo.shape == (feat, feat)
    for split in (prepared.wqkv, prepared.wo):
        assert split.hi.is_contiguous() and split.lo.is_contiguous()
        assert torch.equal(split.hi, jet_attention.tf32_round(split.w.t()))


@pytest.mark.parametrize("changed", ["query", "out"])
@pytest.mark.parametrize("leaf", ["kernel", "bias"])
def test_prepared_weights_are_cached_until_a_parameter_changes(changed, leaf):
    p = attention_params(40, 32, 4)
    first = jet_attention.prepare_weights(p, 4)
    # A second call, also through fresh views of the same parameters, hits the cache.
    assert jet_attention.prepare_weights(p, 4) is first
    views = {n: {k: v.detach() for k, v in d.items()} for n, d in p.items()}
    assert jet_attention.prepare_weights(views, 4) is first
    p[changed][leaf].mul_(2.0)
    second = jet_attention.prepare_weights(p, 4)
    assert second is not first
    fresh = jet_attention.prepare_weights({n: {k: v.clone() for k, v in d.items()} for n, d in p.items()}, 4)
    for got, want in zip(second, fresh):
        for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert torch.equal(a, b)


def random_jet(seed, batch, tokens, feat, c, e):
    shapes = ((batch, tokens, feat), (c, batch, tokens, feat), (batch, tokens, feat), (e, batch, tokens, feat))
    return fwdlap.Jet(*(normal(seed + i, *shape) for i, shape in enumerate(shapes)))


@pytest.mark.parametrize("c,e,t", [(13, 1, 6), (15, 3, 6), (17, 1, 8)])
def test_attention_through_prepared_weights_matches_plain(c, e, t):
    # On the CPU attention_jet runs the three launches' plain versions on the
    # prepared weights; 2e-5 of each field's largest value, as the kernels are held.
    x = random_jet(50 + c, 5, t, 32, c, e)
    p = attention_params(60, 32, 4)
    got = jet_attention.attention_jet(p, 4, x)
    want = jet_attention.attention_jet_plain(p, 4, x)
    assert jet_attention.packed_planes(got) is not None
    for name, a, b in zip(fwdlap.Jet._fields, got, want):
        assert a.shape == b.shape, name
        assert (a - b).abs().max() <= 2e-5 * b.abs().max(), name


def test_attention_sees_a_changed_parameter():
    x = random_jet(70, 3, 6, 32, 5, 1)
    p = attention_params(80, 32, 4)
    before = jet_attention.attention_jet(p, 4, x)
    p["value"]["kernel"].add_(0.5)
    after = jet_attention.attention_jet(p, 4, x)
    want = jet_attention.attention_jet_plain(p, 4, x)
    assert (after.x - before.x).abs().max() > 1e-2
    assert (after.x - want.x).abs().max() <= 2e-5 * want.x.abs().max()


# --- a model of the tensor cores' accumulation ------------------------------------
#
# A MODEL, not the hardware: each wgmma k8 step adds its eight exact products
# to the accumulator by aligning all nine addends to the largest one's
# exponent, truncating each toward zero on that float32 grid, and summing.
# The loss is biased and grows with the accumulate steps.  On the card,
# tests/test_torch_kernels_cuda.py::test_gemm_accuracy_on_cancelling_rows is
# the proof; this guards the kernel's accumulation order on every CPU run.


def model_wgmma_step(acc: torch.Tensor, products: torch.Tensor) -> torch.Tensor:
    """``acc [O]`` plus ``products [O, 8]`` (float64, exact) as the model's tensor cores add them."""
    addends = torch.cat([acc[:, None], products], dim=1)
    largest = addends.abs().amax(dim=1)
    exponent = torch.frexp(torch.where(largest > 0, largest, torch.ones_like(largest))).exponent - 1
    grid = torch.pow(2.0, (exponent - 23).double())[:, None]
    total = (torch.trunc(addends / grid) * grid).sum(dim=1)
    # A carry into the next binade leaves the grid: round toward zero to float32.
    rounded = total.float()
    over = rounded.double().abs() > total.abs()
    rounded[over] = torch.nextafter(rounded[over], torch.zeros_like(rounded[over]))
    return rounded.double()


def model_products(a: torch.Tensor, w: torch.Tensor):
    """Per k8 block ``kk``: the exact products ``[O, 8]`` of lo*hi, hi*lo and hi*hi."""
    a_hi = jet_attention.tf32_round(a)
    a_lo = jet_attention.tf32_round(a - a_hi)
    w_hi = jet_attention.tf32_round(w)
    w_lo = jet_attention.tf32_round(w - w_hi)

    def block(x, y, kk):
        s = slice(8 * kk, 8 * kk + 8)
        return (x[:, None, s].double() * y.t()[None, :, s].double()).reshape(-1, 8)

    return lambda kk: (block(a_lo, w_hi, kk), block(a_hi, w_lo, kk), block(a_hi, w_hi, kk))


def single_accumulator(a, w):
    """The kernel's first order: lo*hi, hi*lo, hi*hi of every k8 block into one accumulator."""
    terms = model_products(a, w)
    acc = torch.zeros(a.shape[0] * w.shape[1], dtype=torch.float64)
    for kk in range(a.shape[1] // 8):
        for p in terms(kk):
            acc = model_wgmma_step(acc, p)
    return acc


def promoted(a, w):
    """The kernel's order: per 32-wide step an accumulator from zero takes the
    small terms of its four k8 blocks, then the four hi*hi; the partial sum is
    added into float32 rounding to nearest."""
    terms = model_products(a, w)
    total = torch.zeros(a.shape[0] * w.shape[1], dtype=torch.float32)
    for k0 in range(0, a.shape[1] // 8, 4):
        blocks = [terms(kk) for kk in range(k0, k0 + 4)]
        part = torch.zeros_like(total, dtype=torch.float64)
        for lo_hi, hi_lo, _ in blocks:
            part = model_wgmma_step(model_wgmma_step(part, lo_hi), hi_lo)
        for _, _, hi_hi in blocks:
            part = model_wgmma_step(part, hi_hi)
        total = total + part.float()
    return total.double()


def fma_chain(a, w):
    """float32 FMAs over K in order, as the CUDA-core kernel sums."""
    acc = torch.zeros(a.shape[0], w.shape[1], dtype=torch.float32)
    for k in range(a.shape[1]):
        acc = (acc.double() + a[:, k, None].double() * w[k].double()).float()
    return acc.reshape(-1).double()


def cancelling_rows(seed, m, k, n, per_row=16, keep=1e-2):
    """``a = u - P u + keep * P u`` with ``P`` the projection onto ``per_row`` columns
    of ``w``: those outputs cancel to about 1e-3 of ``sum_k |a_k| |w_k|``."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.standard_normal((k, n)) / math.sqrt(k)).astype(np.float32))
    u = torch.from_numpy(rng.standard_normal((m, k)))
    a = torch.empty(m, k, dtype=torch.float64)
    mask = torch.zeros(m, n, dtype=torch.bool)
    groups = n // per_row
    for g in range(groups):
        cols = slice(g * per_row, (g + 1) * per_row)
        q, _ = torch.linalg.qr(w[:, cols].double())
        pu = u[g::groups] @ q @ q.T
        a[g::groups] = u[g::groups] - pu + keep * pu
        mask[g::groups, cols] = True
    return a.float(), w, mask.reshape(-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_model_of_the_accumulation_order(seed):
    # In the model, on the outputs that cancel: one accumulator for all 96
    # products loses to a float32 FMA chain (about 3x in median error relative
    # to sum |a||w|); the kernel's order stays within 1.5x of the chain in
    # median and at the 99th percentile (about 1x and 0.7x).
    a, w, mask = cancelling_rows(seed, 128, K, 64)
    exact = (a.double() @ w.double()).reshape(-1)
    scale = (a.double().abs() @ w.double().abs()).reshape(-1)

    def errors(values):
        err = ((values - exact).abs() / scale)[mask]
        return err.median().item(), torch.quantile(err, 0.99).item()

    chain = errors(fma_chain(a, w))
    single = errors(single_accumulator(a, w))
    repaired = errors(promoted(a, w))
    assert single[0] > 1.5 * chain[0]
    assert repaired[0] <= 1.5 * chain[0] and repaired[1] <= 1.5 * chain[1]
