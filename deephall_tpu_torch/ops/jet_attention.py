"""Multi-head self-attention of a forward-Laplacian jet: CUDA kernels and plain version.

Replaces ``deephall_tpu/ops/jet_attention.py:_kernel`` (the Pallas TPU kernel
launched by ``_fused_attention``), which keeps a block of walkers with every
plane, q/k/v included, in VMEM.  A Hopper block has 227 KB of shared memory,
less than one walker's input planes plus one weight, so the port runs three
launches of two hand-written kernels from ``csrc/jet_attention.cu``:

1. :func:`jet_gemm` of the stacked planes ``[P*B*T, D]`` with ``[wq | wk | wv]``
   (1/sqrt(dh) folded into ``wq`` and ``bq``), bias on the primal rows only;
2. :func:`softmax_values`: logits, softmax and value-contraction jets of every
   (walker, head), the planes of a walker's group of heads streamed once
   through shared memory;
3. :func:`jet_gemm` with ``wo``, bias on the primal rows only.

The projections are bound by operations.  The local energy needs float32
products (the TPU kernel's ``Precision.HIGHEST``), which the tensor cores give
as three TF32 products of operands split into ``hi = tf32(x)`` and
``lo = tf32(x - hi)``: ``lo*hi + hi*lo + hi*hi``, summed in float32.  The bound
is ``3 * 2MNK`` at the TF32 rate.  The weights are constant during inference,
so :func:`prepare_weights` splits and transposes them once and caches the
result; the kernel splits only the activations.  The core's bound is bytes;
beyond T = 6 it runs at a bit under half of it (``PERF.md``), held by the
instruction throughput of its products.  PyTorch's TF32 switch is not
involved and stays off.

Each wrapper picks between two hand-written kernels by shape, before the
launch: the tensor-core GEMM takes ``K % 32 == 0`` and ``N % 128 == 0``, the
tiled core ``T = 6``, ``dh = 64`` and ``(C, E)`` in ``(15, 3)``, ``(13, 1)``
(:func:`softmax_values_route`); the generic GEMM and the streamed core take
the rest, the latter up to the shared memory of one block
(:func:`check_softmax_values_shape`: T <= 48 tokens at ``dh = 64`` in both
jet modes).  A jet whose four fields are adjacent views
of one ``[P, B, T, D]`` buffer (what the kernels return) is read with no copy;
any other jet is stacked once.

For CPU tensors every wrapper takes its plain version; :func:`attention_jet`
then runs the same three steps through them.  :func:`attention_jet_plain` is
the ``vpu`` chain of ``deephall_tpu/networks/fwdlap.py:_attention`` with its
contractions written as einsums.  Each wrapper counts its launches in
``.launches``, and those of the card-specific kernel apart.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from deephall_tpu_torch.ops import fwdlap
from deephall_tpu_torch.ops._build import check, function, require, stream
from deephall_tpu_torch.ops.fwdlap import Jet

_PTR = ctypes.c_void_p
_GEMM_TAIL = (ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _PTR)
_GEMM_ARGTYPES = (_PTR,) * 4 + _GEMM_TAIL
_GEMM_TC_ARGTYPES = (_PTR,) * 5 + _GEMM_TAIL
_SV_ARGTYPES = (_PTR, _PTR, ctypes.c_int, ctypes.c_int64) + (ctypes.c_int,) * 5 + (_PTR,)
_SV_PROBE_ARGTYPES = _SV_ARGTYPES[:-1] + (ctypes.c_int,) * 3 + (_PTR,)


# --- the projections ------------------------------------------------------------


class SplitWeight(NamedTuple):
    """A weight and its TF32 halves: ``w [K, N]``; ``hi``, ``lo`` ``[N, K]`` with
    ``hi + lo ~ w.T``, each exactly representable in TF32."""

    w: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Round float32 to TF32 (10 mantissa bits) as ``cvt.rna.tf32.f32`` does:
    to nearest, ties away from zero.  The result is float32 with 13 low bits clear."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split_weight(w: torch.Tensor) -> SplitWeight:
    """Split ``w [K, N]`` for the tensor-core GEMM; ``w - hi`` is exact in float32."""
    w = w.contiguous()
    wt = w.t().contiguous()
    hi = tf32_round(wt)
    return SplitWeight(w, hi, tf32_round(wt - hi))


def jet_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, bias_rows: int):
    out = a @ w
    out[:bias_rows] += bias
    return out


def _aligned(*tensors) -> bool:
    return all(v.data_ptr() % 16 == 0 for v in tensors)


def jet_gemm(a: torch.Tensor, w: torch.Tensor | SplitWeight, bias: torch.Tensor, bias_rows: int):
    """``a [M, K] @ w [K, N]``, plus ``bias [N]`` on the first ``bias_rows`` rows.

    A :class:`SplitWeight` with ``K % 32 == 0`` and ``N % 128 == 0`` goes to the
    tensor cores (three TF32 products, float32 accuracy); a plain tensor or any
    other shape to the float32 kernel on the CUDA cores.
    """
    full = w.w if isinstance(w, SplitWeight) else w
    if a.device.type == "cpu":
        return jet_gemm_plain(a, full, bias, bias_rows)
    m, k = a.shape
    n = full.shape[1]
    require(a, a.device, (m, k), "a")
    require(full, a.device, (k, n), "w")
    require(bias, a.device, (n,), "bias")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    tensor_cores = (
        isinstance(w, SplitWeight) and m > 0 and k % 32 == 0 and n % 128 == 0
        and _aligned(a, w.hi, w.lo, bias, out)
    )
    if tensor_cores:
        require(w.hi, a.device, (n, k), "w.hi")
        require(w.lo, a.device, (n, k), "w.lo")
        status = function("jet_attention", "jet_gemm_tf32x3", _GEMM_TC_ARGTYPES)(
            a.data_ptr(), w.hi.data_ptr(), w.lo.data_ptr(), bias.data_ptr(), out.data_ptr(),
            m, n, k, bias_rows, stream(a.device),
        )
    else:
        status = function("jet_attention", "jet_gemm_f32", _GEMM_ARGTYPES)(
            a.data_ptr(), full.data_ptr(), bias.data_ptr(), out.data_ptr(),
            m, n, k, bias_rows, stream(a.device),
        )
    check(status, "jet_gemm")
    jet_gemm.launches += 1
    jet_gemm.launches_tensor_core += tensor_cores
    return out


jet_gemm.launches = 0
jet_gemm.launches_tensor_core = 0


# --- logits, softmax and value contraction ----------------------------------------


def softmax_values_jet(q: Jet, k: Jet, v: Jet) -> Jet:
    """Scaled-dot-product attention jet of ``[*B, T, H, dh]`` q, k, v jets.

    ``q`` carries the 1/sqrt(dh) scale already.  The softmax over the sources
    is exp / sum / reciprocal / product; its max shift is a constant of the
    linearisation point and cancels exactly.
    """
    logits = fwdlap.bilinear(
        lambda a, b: torch.einsum("...thd,...shd->...tsh", a, b), q, k
    )
    c = torch.amax(logits.x, dim=-2, keepdim=True)
    e = fwdlap.elementwise(fwdlap.exp, fwdlap.shift(logits, -c))
    s = fwdlap.linear(lambda z: z.sum(dim=-2, keepdim=True), e)
    r = fwdlap.elementwise(fwdlap.reciprocal, s)
    w = fwdlap.bilinear(lambda a, b: a * b, e, r)
    return fwdlap.bilinear(
        lambda a, b: torch.einsum("...tsh,...shd->...thd", a, b), w, v
    )


def _split_planes(z: torch.Tensor, c: int) -> Jet:
    """Jet view of a ``[P, ...]`` plane stack in the order x, j, l, d."""
    return Jet(z[0], z[1 : 1 + c], z[1 + c], z[2 + c :])


def softmax_values_plain(qkv, batch: int, tokens: int, heads: int, c: int, e: int):
    """Plain version of :func:`softmax_values` on the same packed layout."""
    planes = c + e + 2
    feat = qkv.shape[-1] // 3
    z = qkv.reshape(planes, batch, tokens, 3, heads, feat // heads)
    q, k, v = (_split_planes(z[..., i, :, :], c) for i in range(3))
    attn = softmax_values_jet(q, k, v)
    return torch.cat(
        [attn.x[None], attn.j, attn.l[None], attn.d], dim=0
    ).reshape(planes * batch * tokens, feat)


# Shared memory one block may have on an H100 (opt-in), and the most planes
# the streamed kernel's ring holds (``csrc/jet_attention.cu:sv_streamed``).
SV_SMEM_LIMIT = 232_448
SV_MAX_STAGES = 4


def softmax_values_smem(tokens: int, head_dim: int, group: int = 1, stages: int = 1) -> int:
    """Bytes of shared memory of the streamed kernel (``sv_streamed::layout``)
    for items of ``group`` heads and a ring of ``stages`` planes.  A plane is
    ``tp`` rows (T rounded up to 4) of the group's ``[q | k | v]``, each head
    ``dhp`` floats (dh rounded up to 4), at a row stride of 4 (mod 8) floats:
    the primal's copy and the ring.  Per head: the logits and the weights of
    two planes and the primal's exponential and weights ``[tp][tp]``, its
    reciprocal ``[tp]``; two slots of cross terms, each ``3 [tp][tp] + [tp]
    + [tp][dhp]``; two mbarriers a stage.  It grows with neither the planes
    nor E."""
    tp = -(-tokens // 4) * 4
    dhp = -(-head_dim // 4) * 4
    ldr = 3 * group * dhp
    ldr += 4 if ldr % 8 == 0 else 0
    floats = ((1 + stages) * tp * ldr + group * (6 * tp * tp + tp)
              + 2 * group * (3 * tp * tp + tp + tp * dhp))
    return 4 * floats + 16 * stages


def check_softmax_values_shape(tokens: int, feat: int, heads: int, c: int, e: int) -> None:
    """Raise ``ValueError`` for a shape that no softmax/values kernel takes.

    The streamed kernel takes any ``1 <= E <= C`` and any head width whose
    layout with one head an item and one stage fits ``SV_SMEM_LIMIT``; that
    grows as ``T dh + T^2``, not with the planes or E (45,776 bytes at N = 16,
    T = 16, dh = 64).
    """
    if heads <= 0 or feat % heads or not 1 <= e <= c or tokens <= 0:
        raise ValueError(f"unsupported attention shape: D={feat}, H={heads}, C={c}, E={e}, T={tokens}")
    need = softmax_values_smem(tokens, feat // heads)
    if need > SV_SMEM_LIMIT:
        raise ValueError(
            f"jet_softmax_values: T={tokens}, dh={feat // heads}, (C, E)=({c}, {e}) need {need} "
            f"bytes of shared memory, past SV_SMEM_LIMIT = {SV_SMEM_LIMIT}"
        )


# (T, dh, C, E) compiled into the tiled kernel: N=6 production, with L^2 and without.
TILED_SHAPES = ((6, 64, 15, 3), (6, 64, 13, 1))


def softmax_values_route(tokens: int, head_dim: int, c: int, e: int, aligned: bool) -> str:
    """The kernel that takes a shape on the card: ``"tiled"`` for ``TILED_SHAPES``
    with 16-byte aligned ``qkv`` and output, else ``"streamed"`` (which copies
    fields off the 16-byte grid, or with ``dh % 4 != 0``, float by float)."""
    return "tiled" if (tokens, head_dim, c, e) in TILED_SHAPES and aligned else "streamed"


def streamed_plan(device, tokens: int, feat: int, heads: int) -> tuple[int, int, int]:
    """``(heads of an item, stages of the ring, computing threads)`` of the
    streamed kernel's launch on ``device``: the most heads (a divisor of H)
    whose layout fits two stages and whose value units one round of 320
    threads takes, else the most heads that fit two stages, else one head;
    then as many stages as fit (at most ``SV_MAX_STAGES``; three or more put
    the Laplacian tangents two a step) and the fewer of 256 and 320 threads
    that take the value units in one round; ``(0, 0, 0)`` where not one
    stage fits."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    fn = function("jet_attention", "jet_softmax_values_streamed_plan", (ctypes.c_int,) * 5)
    return tuple(fn(index, tokens, feat, heads, what) for what in range(3))


def streamed_smem_on_card(tokens: int, head_dim: int, group: int, stages: int) -> int:
    """:func:`softmax_values_smem` as the library computes it."""
    fn = function("jet_attention", "jet_softmax_values_streamed_smem", (ctypes.c_int,) * 4)
    return fn(tokens, head_dim, group, stages)


def softmax_values(qkv: torch.Tensor, batch: int, tokens: int, heads: int, c: int, e: int):
    """Attention jet core on packed planes.

    Args:
        qkv: ``[P*B*T, 3D]`` projections, plane-major (x, j[C], l, d[E]) with
            ``q | k | v`` along the last axis.
        batch, tokens, heads: B, T, H.
        c, e: tangent and extra channel counts (``P = C + E + 2``).

    Returns:
        ``[P*B*T, D]`` attention outputs per plane, heads concatenated.

    :func:`softmax_values_route` names the kernel; a shape that neither takes
    raises before the launch.
    """
    if qkv.device.type == "cpu":
        return softmax_values_plain(qkv, batch, tokens, heads, c, e)
    planes = c + e + 2
    feat = qkv.shape[-1] // 3
    require(qkv, qkv.device, (planes * batch * tokens, 3 * feat), "qkv")
    check_softmax_values_shape(tokens, feat, heads, c, e)
    out = torch.empty((planes * batch * tokens, feat), dtype=torch.float32, device=qkv.device)
    tiled = softmax_values_route(tokens, feat // heads, c, e, _aligned(qkv, out)) == "tiled"
    symbol = "jet_softmax_values_tiled_f32" if tiled else "jet_softmax_values_f32"
    status = function("jet_attention", symbol, _SV_ARGTYPES)(
        qkv.data_ptr(), out.data_ptr(), planes, batch, tokens, feat, heads, c, e,
        stream(qkv.device),
    )
    check(status, "jet_softmax_values")
    softmax_values.launches += 1
    softmax_values.launches_tiled += tiled
    return out


softmax_values.launches = 0
softmax_values.launches_tiled = 0

STREAMED_PROBES = {"whole": 0, "no_store": 1, "no_math": 2}


def softmax_values_probe(qkv: torch.Tensor, batch: int, tokens: int, heads: int, c: int, e: int,
                         probe: str = "whole", group: int = 0, stages: int = 0):
    """The streamed kernel on the card as :func:`softmax_values` launches it, or
    cut down (``probe``: ``no_store`` leaves out the stores, ``no_math`` copies
    each plane's v out with no arithmetic), with items of ``group`` heads and a
    ring of ``stages`` planes (0: the library's choice).  For timing and tests;
    launches are not counted."""
    planes = c + e + 2
    feat = qkv.shape[-1] // 3
    require(qkv, qkv.device, (planes * batch * tokens, 3 * feat), "qkv")
    check_softmax_values_shape(tokens, feat, heads, c, e)
    out = torch.empty((planes * batch * tokens, feat), dtype=torch.float32, device=qkv.device)
    status = function("jet_attention", "jet_softmax_values_streamed_probe_f32", _SV_PROBE_ARGTYPES)(
        qkv.data_ptr(), out.data_ptr(), planes, batch, tokens, feat, heads, c, e,
        STREAMED_PROBES[probe], group, stages, stream(qkv.device),
    )
    check(status, "jet_softmax_values_streamed_probe")
    return out


# --- the whole attention ------------------------------------------------------------


def attention_jet_plain(p: dict, num_heads: int, t: Jet) -> Jet:
    """The jet attention as a chain of jet primitives (``x: [*B, T, D]``)."""
    feat = t.x.shape[-1]
    head_dim = feat // num_heads

    def project(name):
        kernel = p[name]["kernel"].reshape(feat, feat)
        bias = p[name]["bias"].reshape(num_heads, head_dim)
        return fwdlap.linear(
            lambda z: (z @ kernel).reshape(*z.shape[:-1], num_heads, head_dim), t, bias=bias
        )

    q = fwdlap.linear(lambda z: z / math.sqrt(head_dim), project("query"))
    attn = softmax_values_jet(q, project("key"), project("value"))
    kernel = p["out"]["kernel"].reshape(feat, feat)
    return fwdlap.linear(
        lambda z: z.reshape(*z.shape[:-2], feat) @ kernel, attn, bias=p["out"]["bias"]
    )


def attention_work(batch: int, tokens: int, features: int, heads: int, c: int, e: int):
    """``(bytes, core_products, projection_products)`` of one attention layer
    on a jet of ``c`` tangent channels, ``e`` of them extra: the jet read and
    written once with the four weights (float32), the products of the logits
    and value contractions, and those of the q/k/v and output projections,
    each ``2 m n k``.  The kernel table's and the benchmark's bound."""
    elems = (c + e + 2) * batch * tokens * features
    dh = features // heads
    # Dot products of dh terms per (walker, head, query, source) in the
    # logits and in the value contraction: 1 for x, 2 per tangent, 2 + lap
    # for l, 3 per extra.
    core = 2 * 2 * dh * tokens**2 * batch * heads * (1 + 2 * c + 2 + (c - e) + 3 * e)
    nbytes = 2 * elems * 4 + 4 * (features * features + features) * 4
    return nbytes, core, 4 * 2 * elems * features


def packed_planes(t: Jet) -> torch.Tensor | None:
    """The ``[P, *S]`` buffer whose adjacent slices are ``t``'s fields, if there is one."""
    fields = list(t)
    storage = t.x.untyped_storage().data_ptr()
    if not all(f.is_contiguous() and f.untyped_storage().data_ptr() == storage for f in fields):
        return None
    for a, b in zip(fields, fields[1:]):
        if b.data_ptr() != a.data_ptr() + a.numel() * a.element_size():
            return None
    planes = t.j.shape[0] + t.d.shape[0] + 2
    return t.x.as_strided((planes, *t.x.shape), (t.x.numel(), *t.x.stride()))


class AttentionWeights(NamedTuple):
    """What the three launches read: ``[wq/sqrt(dh) | wk | wv]`` and ``wo``, split."""

    wqkv: SplitWeight
    bqkv: torch.Tensor
    wo: SplitWeight
    bo: torch.Tensor


_PREPARED: dict[tuple, tuple] = {}
_PREPARED_MAX = 16


def prepare_weights(p: dict, num_heads: int) -> AttentionWeights:
    """The attention layer's weights as the kernels want them, made once.

    The result is cached by the parameters' addresses and rebuilt when one of
    them was written in place since (``Tensor._version``).  The cache holds the
    parameters it was made from, so an address is not reused while its entry lives.
    """
    sources = tuple(p[name][leaf] for name in ("query", "key", "value", "out")
                    for leaf in ("kernel", "bias"))
    key = (num_heads, *(v.data_ptr() for v in sources))
    versions = tuple(v._version for v in sources)
    hit = _PREPARED.get(key)
    if hit is not None and hit[0] == versions:
        return hit[2]
    feat = p["out"]["bias"].shape[0]
    scale = 1.0 / math.sqrt(feat // num_heads)
    (wq, bq), (wk, bk), (wv, bv), (wo, bo) = (
        (p[name]["kernel"].reshape(feat, feat), p[name]["bias"].reshape(feat))
        for name in ("query", "key", "value", "out")
    )
    prepared = AttentionWeights(
        split_weight(torch.cat([wq * scale, wk, wv], dim=1)),
        torch.cat([bq * scale, bk, bv]).contiguous(),
        split_weight(wo),
        bo.contiguous(),
    )
    _PREPARED.pop(key, None)
    while len(_PREPARED) >= _PREPARED_MAX:
        _PREPARED.pop(next(iter(_PREPARED)))
    _PREPARED[key] = (versions, sources, prepared)
    return prepared


def attention_jet(p: dict, num_heads: int, t: Jet) -> Jet:
    """Multi-head self-attention of a jet with ``x: [B, T, D]``.

    Args:
        p: flax-named weights: ``query``/``key``/``value`` kernels ``[D, H, dh]``
            and biases ``[H, dh]``; ``out`` kernel ``[H, dh, D]`` and bias ``[D]``.
        num_heads: H.
        t: the input jet.

    Returns:
        The output jet; its fields are views of one ``[P, B, T, D]`` buffer.
    """
    device = t.x.device
    if device.type == "cpu" and (t.x.ndim != 3 or t.x.dtype != torch.float32):
        return attention_jet_plain(p, num_heads, t)
    if t.x.ndim != 3:
        raise ValueError(f"attention_jet needs x of shape [B, T, D], got {tuple(t.x.shape)}")
    batch, tokens, feat = t.x.shape
    c, e = t.j.shape[0], t.d.shape[0]
    planes = c + e + 2
    for name, v, want in zip(
        Jet._fields, t, (t.x.shape, (c, *t.x.shape), t.x.shape, (e, *t.x.shape))
    ):
        if v.device != device or v.dtype != torch.float32 or tuple(v.shape) != tuple(want):
            raise TypeError(f"t.{name}: need float32 {tuple(want)} on {device}")

    stacked = packed_planes(t)
    if stacked is None:
        stacked = torch.cat([t.x[None], t.j, t.l[None], t.d], dim=0)
    rows = stacked.reshape(planes * batch * tokens, feat)

    weights = prepare_weights(p, num_heads)
    primal_rows = batch * tokens
    qkv = jet_gemm(rows, weights.wqkv, weights.bqkv, primal_rows)
    attn = softmax_values(qkv, batch, tokens, num_heads, c, e)
    del qkv
    out = jet_gemm(attn, weights.wo, weights.bo, primal_rows)
    if device.type != "cpu":
        attention_jet.launches += 1
    return _split_planes(out.reshape(planes, batch, tokens, feat), c)


attention_jet.launches = 0
