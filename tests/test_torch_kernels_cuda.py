"""The hand-written CUDA kernels against their plain versions, on a card.

These tests need an NVIDIA card with ``nvcc`` (the kernels have no CPU mode)
and skip elsewhere.  Run them on the card with

    python -m pytest tests/test_torch_kernels_cuda.py -m cuda

Tolerance: 2e-5 of each output field's largest value, as the JAX package's
kernel tests hold the Pallas kernels against their chains.
"""

from __future__ import annotations

import ctypes
import json
import math

import pytest
import torch

from deephall_tpu_torch.ops import _build, jet_attention, jet_layernorm
from deephall_tpu_torch.ops.fwdlap import Jet

pytestmark = pytest.mark.cuda

TOL = 2e-5


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_jet(gen, device, batch, tokens, feat, c, e):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device)

    return Jet(normal(batch, tokens, feat), normal(c, batch, tokens, feat),
               normal(batch, tokens, feat), normal(e, batch, tokens, feat))


def assert_close(got, want):
    for name, a, b in zip(Jet._fields, got, want):
        scale = b.abs().max().item() + 1e-30
        err = (a - b).abs().max().item() / scale
        assert err <= TOL, f"{name}: {err:.2e}"


def layernorm_params(gen, device, feat):
    return {"scale": torch.randn(feat, generator=gen, device=device) * 0.3 + 1,
            "bias": torch.randn(feat, generator=gen, device=device) * 0.1}


def kernel_for(feat, c, e, residual):
    """The kernel the routing rule names for a jet whose fields are aligned."""
    stages = jet_layernorm.staged_stages(torch.cuda.current_device(), feat, c, e, residual)
    return jet_layernorm.route(feat, c, e, residual, 1, True, stages)


def run_layernorm(p, x, r, kernel, fn=jet_layernorm.layernorm_jet):
    """``fn``'s result, after checking which of the three kernels it launched."""
    counts = jet_layernorm.layernorm_jet
    before = counts.launches, counts.launches_streamed, counts.launches_staged
    got = fn(p, x, residual=r)
    torch.cuda.synchronize()
    after = counts.launches, counts.launches_streamed, counts.launches_staged
    assert after == (before[0] + 1, before[1] + (kernel == "streamed"),
                     before[2] + (kernel == "staged")), kernel
    return got


# 37 walkers of 6 tokens are 222 rows: no multiple of the streamed kernel's
# rows per block, and no multiple of the staged kernel's grid.  The streamed
# kernel takes the production shapes with a residual, the staged kernel every
# other jet whose row fits one stage (N = 8, 10, 12, 16 and C = 64 at D = 256,
# D = 64 and 512), the generic kernel the rest (C = 64 at D = 1024).
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c,e,t,feat", [
    (13, 1, 6, 256), (15, 3, 6, 256), (17, 1, 8, 64), (5, 2, 3, 512),
    (19, 3, 8, 256), (21, 1, 10, 256), (23, 3, 10, 256), (25, 1, 12, 256), (27, 3, 12, 256),
    (35, 3, 16, 256), (35, 3, 4, 512), (17, 1, 8, 256), (64, 4, 4, 256), (64, 4, 2, 1024),
    (31, 3, 14, 256),
])
def test_layernorm_kernel(device, c, e, t, feat, residual):
    gen = torch.Generator(device=device).manual_seed(c + feat)
    x = random_jet(gen, device, 37, t, feat, c, e)
    r = random_jet(gen, device, 37, t, feat, c, e) if residual else None
    p = layernorm_params(gen, device, feat)
    got = run_layernorm(p, x, r, kernel_for(feat, c, e, residual))
    assert_close(got, jet_layernorm.layernorm_jet_plain(p, x, residual=r))


@pytest.mark.parametrize("c,e", [(13, 1), (15, 3)])
def test_layernorm_kernel_production_rows(device, c, e):
    gen = torch.Generator(device=device).manual_seed(c)
    x, r = (random_jet(gen, device, 3360, 6, 256, c, e) for _ in range(2))
    p = layernorm_params(gen, device, 256)
    got = run_layernorm(p, x, r, "streamed")
    assert_close(got, jet_layernorm.layernorm_jet_plain(p, x, residual=r))


# The staged kernel at the row count of a batch of 3360 walkers of 10 tokens,
# every shape beyond N = 6 that it takes (N = 8, 10, 12, 14, 16, and C = 64).
@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c,e", [(17, 1), (19, 3), (21, 1), (23, 3), (27, 3), (35, 3), (64, 4),
                                 (31, 3)])
def test_staged_kernel_production_rows(device, c, e, residual):
    gen = torch.Generator(device=device).manual_seed(100 + c)
    x = random_jet(gen, device, 3360, 10, 256, c, e)
    r = random_jet(gen, device, 3360, 10, 256, c, e) if residual else None
    p = layernorm_params(gen, device, 256)
    got = run_layernorm(p, x, r, "staged")
    assert_close(got, jet_layernorm.layernorm_jet_plain(p, x, residual=r))


# The stages of the staged kernel's ring on an H100 (232,448 bytes of shared
# memory a block): as many as fit, at most 8, one or an even number.  N = 10,
# 12 and 16 with L^2 and C = 64, E = 4 at D = 256 with a residual; without
# one; D = 512 and 1024.
@pytest.mark.parametrize("feat,c,e,residual,stages", [
    (256, 23, 3, True, 4),
    (256, 27, 3, True, 2),  # 3 fit
    (256, 35, 3, True, 2),
    (256, 64, 4, True, 1),
    (256, 21, 1, True, 4),
    (256, 19, 3, True, 4),
    (256, 15, 3, True, 4),  # 5 fit
    (256, 23, 3, False, 8),  # the kernel's most
    (256, 64, 4, False, 2),  # 3 fit
    (512, 35, 3, True, 1),
    (512, 64, 4, True, 0),  # a row past one stage
    (1024, 64, 4, False, 0),  # D past the kernel's 512
])
def test_staged_stages_on_the_card(device, feat, c, e, residual, stages):
    assert jet_layernorm.staged_stages(torch.cuda.current_device(), feat, c, e, residual) == stages


@pytest.mark.parametrize("compute_l2", [True, False])
def test_staged_takes_every_system_up_to_16_on_the_card(device, compute_l2):
    """At D = 256 every jet LayerNorm of N <= 16, and of N = 30 with L^2, goes
    to the staged kernel on the card; only N = 6 with a residual stays on the
    streamed kernel."""
    for nelec in [*range(1, 17), *([30] if compute_l2 else [])]:
        c, e = (2 * nelec + 3, 3) if compute_l2 else (2 * nelec + 1, 1)
        for residual in (True, False):
            want = "streamed" if nelec == 6 and residual else "staged"
            assert kernel_for(256, c, e, residual) == want, (nelec, residual)


_STAGED_PROBE_ARGTYPES = jet_layernorm._ARGTYPES[:-1] + (ctypes.c_int,) * 2 + (ctypes.c_void_p,)


def staged_ring(p, x, r, stages):
    """The staged kernel with at most ``stages`` stages in its ring, through
    its timing entry point (an odd number past one runs one fewer)."""
    c, e, feat = x.j.shape[0], x.d.shape[0], x.x.shape[-1]
    out = torch.empty((c + e + 2, *x.x.shape), device=x.x.device)
    fields = Jet(out[0], out[1 : 1 + c], out[1 + c], out[2 + c :])
    res = r if r is not None else (None,) * 4
    ptrs = [v.data_ptr() if v is not None else None for v in (*x, *res)]
    ptrs += [v.data_ptr() for v in (p["scale"], p["bias"], *fields)]
    fn = _build.function("jet_layernorm", "jet_layernorm_staged_probe_f32", _STAGED_PROBE_ARGTYPES)
    status = fn(*ptrs, x.x.numel() // feat, feat, c, e, 1e-5, 0, stages, _build.stream(x.x.device))
    assert status == 0, f"CUDA error {status}"
    torch.cuda.synchronize()
    return fields


# Every ring the kernel may be asked for, on 33,600 rows: rows i and i + S of
# a block share a stage, and an odd ring past one would hand them to different
# groups of warps.  Without a residual 8 stages of N = 10 fit, with one 3 of
# N = 12.
@pytest.mark.parametrize("c,e,residual,most", [(23, 3, False, 8), (27, 3, True, 3)])
def test_staged_kernel_every_ring(device, c, e, residual, most):
    gen = torch.Generator(device=device).manual_seed(7 + c)
    x = random_jet(gen, device, 3360, 10, 256, c, e)
    r = random_jet(gen, device, 3360, 10, 256, c, e) if residual else None
    p = layernorm_params(gen, device, 256)
    want = jet_layernorm.layernorm_jet_plain(p, x, residual=r)
    for stages in range(1, most + 1):
        for _ in range(3):
            assert_close(staged_ring(p, x, r, stages), want)


def centred_moment_inputs(device, c, e, residual):
    gen = torch.Generator(device=device).manual_seed(11)
    x = Jet(*(v + 100 for v in random_jet(gen, device, 37, 6, 256, c, e)))
    r = random_jet(gen, device, 37, 6, 256, c, e) if residual else None
    p = layernorm_params(gen, device, 256)
    want = jet_layernorm.layernorm_jet_plain(
        {k: v.double() for k, v in p.items()}, Jet(*(v.double() for v in x)),
        residual=Jet(*(v.double() for v in r)) if residual else None,
    )
    return p, x, r, want


@pytest.mark.parametrize("residual", [False, True])  # the staged kernel, the streamed kernel
def test_layernorm_kernels_keep_centred_moments(device, residual):
    """Rows with a mean of 100 and a spread of 1, against float64 on the same inputs.

    The float32 plain version stays under 5e-6 of each field's largest value
    there; a one-pass variance would be off by about 1e-3.
    """
    p, x, r, want = centred_moment_inputs(device, 15, 3, residual)
    got = run_layernorm(p, x, r, "streamed" if residual else "staged")
    assert_close(got, want)


@pytest.mark.parametrize("kernel", ["staged", "generic"])
def test_kernels_keep_centred_moments_beyond_n6(device, kernel):
    """The same rows at N = 10 with L^2 and a residual, through the staged
    kernel and through the generic kernel's own entry point."""
    p, x, r, want = centred_moment_inputs(device, 23, 3, True)
    fn = jet_layernorm.layernorm_jet if kernel == "staged" else jet_layernorm.layernorm_jet_generic
    assert_close(run_layernorm(p, x, r, kernel, fn), want)


def test_unaligned_jet_takes_the_generic_kernel(device):
    """A field 4 bytes off the 16-byte grid: no bulk copy can read it, so the
    staged kernel is not taken and the generic one is."""
    c, e, t, feat = 23, 3, 10, 256
    gen = torch.Generator(device=device).manual_seed(3)
    x, r = (random_jet(gen, device, 37, t, feat, c, e) for _ in range(2))
    flat = torch.empty(x.x.numel() + 1, device=device)
    shifted = flat[1:].view(x.x.shape)
    shifted.copy_(x.x)
    assert shifted.data_ptr() % 16 == 4
    x = Jet(shifted, x.j, x.l, x.d)
    p = layernorm_params(gen, device, feat)
    got = run_layernorm(p, x, r, "generic")
    assert_close(got, jet_layernorm.layernorm_jet_plain(p, x, residual=r))


@pytest.mark.parametrize("c,e,t,feat,heads", [
    (13, 1, 6, 256, 4), (15, 3, 6, 256, 4), (17, 1, 8, 64, 4),
    (19, 3, 8, 256, 4), (23, 3, 10, 256, 4), (27, 3, 12, 256, 4), (35, 3, 16, 256, 4),
    (31, 3, 14, 256, 4),
])
def test_attention_kernels(device, c, e, t, feat, heads):
    gen = torch.Generator(device=device).manual_seed(c + t)
    x = random_jet(gen, device, 33, t, feat, c, e)
    dh = feat // heads

    def normal(*shape, scale):
        return torch.randn(shape, generator=gen, device=device) * scale

    p = {n: {"kernel": normal(feat, heads, dh, scale=1 / math.sqrt(feat)),
             "bias": normal(heads, dh, scale=0.1)} for n in ("query", "key", "value")}
    p["out"] = {"kernel": normal(heads, dh, feat, scale=1 / math.sqrt(feat)),
                "bias": normal(feat, scale=0.1)}
    got = jet_attention.attention_jet(p, heads, x)
    torch.cuda.synchronize()
    assert_close(got, jet_attention.attention_jet_plain(p, heads, x))
    # A jet that is already one packed buffer (a kernel's output) is read in place.
    assert jet_attention.packed_planes(got) is not None
    again = jet_attention.attention_jet(p, heads, got)
    assert_close(again, jet_attention.attention_jet_plain(p, heads, got))


def gemm_inputs(gen, device, m, k, n):
    a = torch.randn(m, k, generator=gen, device=device)
    w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
    b = torch.randn(n, generator=gen, device=device) * 0.1
    return a, w, b


# Shapes the tensor-core kernel takes (K % 32 == 0, N % 128 == 0; M is free:
# less than a tile, ragged, several tiles per block) and shapes it does not.
@pytest.mark.parametrize("m,k,n,tensor_cores", [
    (256, 64, 128, True), (37, 32, 128, True), (1000, 256, 768, True), (70001, 256, 256, True),
    (300, 20, 128, False), (300, 64, 24, False), (129, 16, 4, False), (300, 48, 128, False),
])
def test_gemm_kernels(device, m, k, n, tensor_cores):
    gen = torch.Generator(device=device).manual_seed(m + k + n)
    a, w, b = gemm_inputs(gen, device, m, k, n)
    bias_rows = m // 3
    fn = jet_attention.jet_gemm
    before = fn.launches, fn.launches_tensor_core
    got = fn(a, jet_attention.split_weight(w), b, bias_rows)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_tensor_core) == (before[0] + 1, before[1] + tensor_cores)
    want = a.double() @ w.double()
    want[:bias_rows] += b.double()
    assert (got - want).abs().max().item() <= TOL * want.abs().max().item()
    # A plain tensor as the weight always takes the float32 kernel.
    generic = fn(a, w, b, bias_rows)
    assert fn.launches_tensor_core == before[1] + tensor_cores
    assert (generic - want).abs().max().item() <= TOL * want.abs().max().item()


# The tiled kernel takes T = 6 at the production modes, the streamed kernel
# the rest: N = 8 to 25 in both modes among them, 37 walkers (no multiple of
# the grid) and the whole batch of 3360 at N = 10.
@pytest.mark.parametrize("c,e,t,dh,heads,batch,tiled", [
    (15, 3, 6, 64, 4, 3, True), (13, 1, 6, 64, 4, 301, True), (15, 3, 6, 64, 2, 150, True),
    (17, 1, 8, 16, 4, 33, False), (13, 1, 6, 32, 4, 33, False), (14, 2, 6, 64, 4, 33, False),
    (19, 3, 8, 64, 4, 33, False), (21, 1, 10, 64, 4, 33, False), (23, 3, 10, 64, 4, 33, False),
    (25, 1, 12, 64, 4, 33, False), (27, 3, 12, 64, 4, 33, False), (35, 3, 16, 64, 4, 33, False),
    (2, 2, 3, 8, 2, 5, False), (17, 1, 8, 64, 4, 33, False), (45, 3, 21, 64, 4, 33, False),
    (53, 3, 25, 64, 4, 9, False), (51, 1, 25, 64, 4, 9, False), (23, 3, 10, 64, 4, 37, False),
    (21, 1, 10, 64, 4, 3360, False), (5, 1, 5, 6, 2, 9, False), (31, 3, 14, 64, 4, 33, False),
])
def test_softmax_values_kernels(device, c, e, t, dh, heads, batch, tiled):
    gen = torch.Generator(device=device).manual_seed(c + batch)
    qkv = torch.randn((c + e + 2) * batch * t, 3 * heads * dh, generator=gen, device=device)
    assert jet_attention.softmax_values_route(t, dh, c, e, True) == ("tiled" if tiled else "streamed")
    fn = jet_attention.softmax_values
    before = fn.launches, fn.launches_tiled
    got = fn(qkv, batch, t, heads, c, e)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_tiled) == (before[0] + 1, before[1] + tiled)
    assert_softmax_values_close(got, qkv, batch, t, heads, c, e)


def assert_softmax_values_close(got, qkv, batch, t, heads, c, e):
    """``got`` within TOL of the plain version in float64, plane by plane."""
    want = jet_attention.softmax_values_plain(qkv.double(), batch, t, heads, c, e)
    planes = c + e + 2
    err = (got.reshape(planes, -1) - want.reshape(planes, -1)).abs().amax(1)
    assert (err <= TOL * want.reshape(planes, -1).abs().amax(1)).all()


# A view off the 16-byte grid goes to the streamed kernel, which copies it
# float by float: at N = 10 and at a shape the tiled kernel takes aligned.
@pytest.mark.parametrize("c,e,t", [(23, 3, 10), (15, 3, 6)])
def test_softmax_values_unaligned_view(device, c, e, t):
    gen = torch.Generator(device=device).manual_seed(c)
    batch, heads, feat = 37, 4, 256
    rows = (c + e + 2) * batch * t
    qkv = torch.randn(rows * 3 * feat + 1, generator=gen, device=device)[1:].view(rows, 3 * feat)
    assert jet_attention.softmax_values_route(t, feat // heads, c, e, False) == "streamed"
    fn = jet_attention.softmax_values
    before = fn.launches, fn.launches_tiled
    got = fn(qkv, batch, t, heads, c, e)
    torch.cuda.synchronize()
    assert (fn.launches, fn.launches_tiled) == (before[0] + 1, before[1])
    assert_softmax_values_close(got, qkv, batch, t, heads, c, e)


# Every head group and ring length the kernel can run, from one stage to the
# most that fit one block (with three stages or more the Laplacian tangents go
# two a step), at N = 10 with L^2 and at N = 12 and 16 (4x4 tiles), and the
# library's layout against the wrapper's count.
@pytest.mark.parametrize("c,e,t", [(23, 3, 10), (25, 1, 12), (35, 3, 16)])
def test_streamed_kernel_every_ring(device, c, e, t):
    gen = torch.Generator(device=device).manual_seed(7 * t)
    batch, heads, dh = 37, 4, 64
    qkv = torch.randn((c + e + 2) * batch * t, 3 * heads * dh, generator=gen, device=device)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    for group in (1, 2, 4):
        for stages in range(1, jet_attention.SV_MAX_STAGES + 1):
            nbytes = jet_attention.softmax_values_smem(t, dh, group, stages)
            assert jet_attention.streamed_smem_on_card(t, dh, group, stages) == nbytes
            if nbytes > limit:
                with pytest.raises(RuntimeError, match="CUDA error"):
                    jet_attention.softmax_values_probe(qkv, batch, t, heads, c, e, group=group,
                                                       stages=stages)
                continue
            got = jet_attention.softmax_values_probe(qkv, batch, t, heads, c, e, group=group,
                                                     stages=stages)
            torch.cuda.synchronize()
            assert_softmax_values_close(got, qkv, batch, t, heads, c, e)


# The library's plan on an H100 (232,448 bytes of shared memory a block):
# (heads of an item, stages of the ring, computing threads).
@pytest.mark.parametrize("t,plan", [
    (6, (4, 4, 256)), (8, (4, 4, 256)), (10, (4, 3, 320)), (12, (4, 3, 256)), (16, (4, 2, 256)),
    (17, (2, 4, 320)), (21, (2, 3, 320)), (25, (1, 4, 256)), (48, (1, 1, 256)), (49, (0, 0, 0)),
])
def test_streamed_plan_on_the_card(device, t, plan):
    if torch.cuda.get_device_properties(device).shared_memory_per_block_optin != 232_448:
        pytest.skip("the plans are stated for an H100")
    assert jet_attention.streamed_plan(device, t, 256, 4) == plan


def test_streamed_kernel_probes(device):
    """The probes launch: without arithmetic each plane's v is copied out, head
    by head, single planes and pairs alike; the whole kernel through the
    probe entry point matches the plain version."""
    gen = torch.Generator(device=device).manual_seed(3)
    c, e, t, batch, heads, dh = 21, 1, 10, 37, 4, 64
    planes = c + e + 2
    qkv = torch.randn(planes * batch * t, 3 * heads * dh, generator=gen, device=device)
    copied = jet_attention.softmax_values_probe(qkv, batch, t, heads, c, e, "no_math")
    torch.cuda.synchronize()
    assert torch.equal(copied, qkv[:, 2 * heads * dh:])
    quiet = jet_attention.softmax_values_probe(qkv, batch, t, heads, c, e, "no_store")
    whole = jet_attention.softmax_values_probe(qkv, batch, t, heads, c, e)
    torch.cuda.synchronize()
    assert_softmax_values_close(whole, qkv, batch, t, heads, c, e)
    assert quiet.shape == whole.shape


def test_kernels_refuse_what_they_do_not_take(device):
    gen = torch.Generator(device=device).manual_seed(0)
    x = random_jet(gen, device, 4, 6, 48, 5, 1)  # D % 32 != 0
    p = {"scale": torch.ones(48, device=device), "bias": torch.zeros(48, device=device)}
    with pytest.raises(ValueError):
        jet_layernorm.layernorm_jet(p, x)
    double = Jet(*(v.double() for v in random_jet(gen, device, 4, 6, 64, 5, 1)))
    p64 = {"scale": torch.ones(64, device=device), "bias": torch.zeros(64, device=device)}
    with pytest.raises(TypeError):
        jet_layernorm.layernorm_jet(p64, double)
    a = torch.randn(8, 16, device=device).t()  # not contiguous
    with pytest.raises(ValueError):
        jet_attention.jet_gemm(a, torch.randn(8, 4, device=device), torch.zeros(4, device=device), 2)
    # N = 49 with L^2: past the softmax/values kernel's shared memory, and C = 65
    # past the LayerNorm's register capacity; both raise before any launch.
    fn = jet_attention.softmax_values
    before = fn.launches
    qkv = torch.zeros(106 * 2 * 49, 3 * 256, device=device)
    with pytest.raises(ValueError, match="SV_SMEM_LIMIT"):
        fn(qkv, 2, 49, 4, 101, 3)
    assert fn.launches == before
    wide = random_jet(gen, device, 2, 3, 64, 65, 3)
    with pytest.raises(ValueError, match="MAX_TANGENTS"):
        jet_layernorm.layernorm_jet(p64, wide)


def cancelling_rows(gen, m, k, n, per_row=64, keep=1e-2):
    """Rows ``a`` whose products with ``per_row`` columns of ``w`` cancel to about 1e-3.

    Row ``i`` belongs to group ``g = i % (n // per_row)``: with ``P`` the
    projection onto that group's columns of ``w``, ``a = u - P u + keep * P u``,
    so that ``a @ w[:, j]`` of a column ``j`` of the group is ``keep`` times
    ``u @ w[:, j]``, about 1e-3 of ``sum_k |a_k| |w_kj|``.  Returns ``(a, w, mask)``
    with ``mask`` marking the cancelling outputs; built in float64.
    """
    device = gen.device
    w = torch.randn(k, n, generator=gen, device=device) / math.sqrt(k)
    u = torch.randn(m, k, generator=gen, device=device, dtype=torch.float64)
    a = torch.empty(m, k, dtype=torch.float64, device=device)
    mask = torch.zeros(m, n, dtype=torch.bool, device=device)
    groups = n // per_row
    for g in range(groups):
        cols = slice(g * per_row, (g + 1) * per_row)
        q, _ = torch.linalg.qr(w[:, cols].double())
        pu = (u[g::groups] @ q) @ q.T
        a[g::groups] = u[g::groups] - pu + keep * pu
        mask[g::groups, cols] = True
    return a.float(), w, mask


def quantile(x: torch.Tensor, q: float) -> float:
    x = x.flatten().sort().values
    return x[min(int(q * x.numel()), x.numel() - 1)].item()


def test_gemm_accuracy_on_cancelling_rows(device):
    """The tensor-core jet_gemm against float64 where rows cancel, at the q/k/v shape.

    Each output's error is taken relative to ``sum_k |a_k| |w_k|``, its scale
    before cancellation.  A float32 product's rounding error is a fixed share
    of that scale, so on the cancelling outputs the tensor-core kernel's median
    and 99.9th percentile must stay within 1.5x of the float32 CUDA-core
    kernel's (``torch.matmul`` with TF32 off is printed beside them).
    """
    m, k, n = 20160, 256, 768
    gen = torch.Generator(device=device).manual_seed(5)
    a, w, mask = cancelling_rows(gen, m, k, n)
    bias = torch.zeros(n, device=device)
    exact = a.double() @ w.double()
    scale = a.double().abs() @ w.double().abs()
    assert quantile((exact.abs() / scale)[mask], 0.5) < 2e-3
    fn = jet_attention.jet_gemm
    before = fn.launches_tensor_core
    paths = {
        "tensor_cores": fn(a, jet_attention.split_weight(w), bias, 0),
        "cuda_cores": fn(a, w, bias, 0),
        "matmul": torch.matmul(a, w),
    }
    torch.cuda.synchronize()
    assert fn.launches_tensor_core == before + 1
    report = {}
    for name, got in paths.items():
        err = (got.double() - exact).abs() / scale
        report[name] = {f"{part}_{label}": quantile(err[sel], q)
                        for part, sel in (("cancelling", mask), ("other", ~mask))
                        for label, q in (("median", 0.5), ("p999", 0.999))}
    print(json.dumps({"gemm_accuracy": report, "m": m, "k": k, "n": n}))
    for stat in ("cancelling_median", "cancelling_p999"):
        got, limit = report["tensor_cores"][stat], 1.5 * report["cuda_cores"][stat]
        assert got <= limit, f"{stat}: tensor cores {got:.3e} > 1.5x CUDA cores ({limit:.3e})"
