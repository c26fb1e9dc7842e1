"""The work of one call of the port's hand-written jet kernels, from its shapes.

``attention_work`` is a copy of ``deephall_tpu_torch/ops/jet_attention.py:
attention_work``; the LayerNorm's bytes are those of the kernel table in
``PERF.md``.  Frozen here so that a change to the program cannot change the
yardstick.  The least time of a call is the larger of its operations at
their peaks and its bytes at the HBM's rate (an H100 SXM at 700 W).
"""

from __future__ import annotations

from typing import NamedTuple

FLOAT32_RATE = 67e12  # products outside the tensor cores
TF32X3_RATE = 495e12 / 3  # float32 products as three TF32 products on the tensor cores
MEMORY_RATE = 3.35e12


class Least(NamedTuple):
    seconds: float
    bound: str  # "operations" or "bytes"


def attention_work(batch: int, tokens: int, features: int, heads: int, c: int, e: int):
    """``(bytes, core_products, projection_products)`` of one attention layer
    on a jet of ``c`` tangent channels, ``e`` of them extra: the jet read and
    written once with the four weights (float32), the products of the logits
    and value contractions, and those of the q/k/v and output projections,
    each ``2 m n k``."""
    elems = (c + e + 2) * batch * tokens * features
    dh = features // heads
    # Dot products of dh terms per (walker, head, query, source) in the
    # logits and in the value contraction: 1 for x, 2 per tangent, 2 + lap
    # for l, 3 per extra.
    core = 2 * 2 * dh * tokens**2 * batch * heads * (1 + 2 * c + 2 + (c - e) + 3 * e)
    nbytes = 2 * elems * 4 + 4 * (features * features + features) * 4
    return nbytes, core, 4 * 2 * elems * features


def attention_least(batch, tokens, features, heads, c, e) -> Least:
    """The least time of one jet attention (its GEMMs on the tensor cores,
    its softmax and values on the float32 units)."""
    nbytes, core, projections = attention_work(batch, tokens, features, heads, c, e)
    ops = core / FLOAT32_RATE + projections / TF32X3_RATE
    by_bytes = nbytes / MEMORY_RATE
    return Least(ops, "operations") if ops >= by_bytes else Least(by_bytes, "bytes")


def layernorm_bytes(batch: int, tokens: int, features: int, c: int, e: int, residual: bool) -> int:
    """The jet read once and written once, and the residual jet read once."""
    return (c + e + 2) * batch * tokens * features * 4 * (3 if residual else 2)


def layernorm_least(batch, tokens, features, c, e, residual) -> Least:
    return Least(layernorm_bytes(batch, tokens, features, c, e, residual) / MEMORY_RATE, "bytes")


def jet_channels(nelec: int, compute_l2: bool) -> tuple[int, int]:
    """``(C, E)`` of the local energy's jet: two tangents an electron and the
    Lz direction, and with L^2 the x and y rotations besides."""
    return (2 * nelec + 3, 3) if compute_l2 else (2 * nelec + 1, 1)
