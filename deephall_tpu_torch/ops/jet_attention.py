"""Multi-head self-attention of a forward-Laplacian jet: CUDA kernels and plain version.

Replaces ``deephall_tpu/ops/jet_attention.py:_kernel`` (the Pallas TPU kernel
launched by ``_fused_attention``), which keeps a block of walkers with every
plane, q/k/v included, in VMEM.  A Hopper block has 227 KB of shared memory,
less than one walker's input planes plus one weight, so the port runs three
launches of two hand-written kernels from ``csrc/jet_attention.cu``:

1. :func:`jet_gemm` of the stacked planes ``[P*B*T, D]`` with ``[wq | wk | wv]``
   (1/sqrt(dh) folded into ``wq`` and ``bq``), bias on the primal rows only;
2. :func:`softmax_values`: logits, softmax and value-contraction jets, one
   block per (walker, head) with that head's q/k/v planes in shared memory;
3. :func:`jet_gemm` with ``wo``, bias on the primal rows only.

The work is bound by operations: the four projections are ``8 P B T D^2``
flops in full float32 on the CUDA cores (no TF32, as the TPU kernel's
``Precision.HIGHEST``).  A jet whose four fields are adjacent views of one
``[P, B, T, D]`` buffer (what the kernels return) is read with no copy; any
other jet is stacked once.

:func:`attention_jet` runs the kernels for CUDA tensors and the plain version
(:func:`attention_jet_plain`, the ``vpu`` chain of
``deephall_tpu/networks/fwdlap.py:_attention`` with its contractions written as
einsums) for CPU tensors.  Each wrapper counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from deephall_tpu_torch.ops import fwdlap
from deephall_tpu_torch.ops._build import check, function, require, stream
from deephall_tpu_torch.ops.fwdlap import Jet

_PTR = ctypes.c_void_p
_GEMM_ARGTYPES = (_PTR,) * 4 + (ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int64, _PTR)
_SV_ARGTYPES = (_PTR, _PTR, ctypes.c_int, ctypes.c_int64) + (ctypes.c_int,) * 5 + (_PTR,)


# --- the projections ------------------------------------------------------------


def jet_gemm_plain(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, bias_rows: int):
    out = a @ w
    out[:bias_rows] += bias
    return out


def jet_gemm(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, bias_rows: int):
    """``a [M, K] @ w [K, N]``, plus ``bias [N]`` on the first ``bias_rows`` rows."""
    if a.device.type == "cpu":
        return jet_gemm_plain(a, w, bias, bias_rows)
    m, k = a.shape
    n = w.shape[1]
    require(a, a.device, (m, k), "a")
    require(w, a.device, (k, n), "w")
    require(bias, a.device, (n,), "bias")
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    status = function("jet_attention", "jet_gemm_f32", _GEMM_ARGTYPES)(
        a.data_ptr(), w.data_ptr(), bias.data_ptr(), out.data_ptr(),
        m, n, k, bias_rows, stream(a.device),
    )
    check(status, "jet_gemm")
    jet_gemm.launches += 1
    return out


jet_gemm.launches = 0


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


def softmax_values(qkv: torch.Tensor, batch: int, tokens: int, heads: int, c: int, e: int):
    """Attention jet core on packed planes.

    Args:
        qkv: ``[P*B*T, 3D]`` projections, plane-major (x, j[C], l, d[E]) with
            ``q | k | v`` along the last axis.
        batch, tokens, heads: B, T, H.
        c, e: tangent and extra channel counts (``P = C + E + 2``).

    Returns:
        ``[P*B*T, D]`` attention outputs per plane, heads concatenated.
    """
    if qkv.device.type == "cpu":
        return softmax_values_plain(qkv, batch, tokens, heads, c, e)
    planes = c + e + 2
    feat = qkv.shape[-1] // 3
    require(qkv, qkv.device, (planes * batch * tokens, 3 * feat), "qkv")
    if feat % heads or not 1 <= e <= c:
        raise ValueError(f"unsupported attention shape: D={feat}, H={heads}, C={c}, E={e}")
    out = torch.empty((planes * batch * tokens, feat), dtype=torch.float32, device=qkv.device)
    status = function("jet_attention", "jet_softmax_values_f32", _SV_ARGTYPES)(
        qkv.data_ptr(), out.data_ptr(), planes, batch, tokens, feat, heads, c, e,
        stream(qkv.device),
    )
    check(status, "jet_softmax_values")
    softmax_values.launches += 1
    return out


softmax_values.launches = 0


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


def attention_jet(p: dict, num_heads: int, t: Jet) -> Jet:
    """Multi-head self-attention of a jet with ``x: [B, T, D]``.

    Args:
        p: flax-named weights: ``query``/``key``/``value`` kernels ``[D, H, dh]``
            and biases ``[H, dh]``; ``out`` kernel ``[H, dh, D]`` and bias ``[D]``.
        num_heads: H.
        t: the input jet.

    Returns:
        The output jet; on CUDA its fields are views of one ``[P, B, T, D]`` buffer.
    """
    if t.x.device.type == "cpu":
        return attention_jet_plain(p, num_heads, t)
    if t.x.ndim != 3:
        raise ValueError(f"attention_jet needs x of shape [B, T, D], got {tuple(t.x.shape)}")
    device = t.x.device
    batch, tokens, feat = t.x.shape
    c, e = t.j.shape[0], t.d.shape[0]
    planes = c + e + 2
    for name, v, want in zip(
        Jet._fields, t, (t.x.shape, (c, *t.x.shape), t.x.shape, (e, *t.x.shape))
    ):
        if v.device != device or v.dtype != torch.float32 or tuple(v.shape) != tuple(want):
            raise TypeError(f"t.{name}: need float32 {tuple(want)} on {device}")
    head_dim = feat // num_heads
    scale = 1.0 / math.sqrt(head_dim)

    stacked = packed_planes(t)
    if stacked is None:
        stacked = torch.cat([t.x[None], t.j, t.l[None], t.d], dim=0)
    rows = stacked.reshape(planes * batch * tokens, feat)

    def weight(name):
        return p[name]["kernel"].reshape(feat, feat), p[name]["bias"].reshape(feat)

    (wq, bq), (wk, bk), (wv, bv) = weight("query"), weight("key"), weight("value")
    wqkv = torch.cat([wq * scale, wk, wv], dim=1).contiguous()
    bqkv = torch.cat([bq * scale, bk, bv]).contiguous()
    primal_rows = batch * tokens
    qkv = jet_gemm(rows, wqkv, bqkv, primal_rows)
    attn = softmax_values(qkv, batch, tokens, num_heads, c, e)
    del qkv
    wo, bo = weight("out")
    out = jet_gemm(attn, wo.contiguous(), bo.contiguous(), primal_rows)
    attention_jet.launches += 1
    return _split_planes(out.reshape(planes, batch, tokens, feat), c)


attention_jet.launches = 0
