"""LayerNorm of a forward-Laplacian jet: hand-written CUDA kernel and plain version.

Replaces ``deephall_tpu/ops/jet_layernorm.py:_kernel`` (the Pallas TPU kernel
launched by ``_fused_rows``).  The kernels of ``csrc/jet_layernorm.cu`` normalise
every plane of a jet row in one pass, with the optional residual added on load,
so each element is read once and written once: the work is bound by bytes on
the H100 and one pass is the least it can move.  There are three: the
streamed kernel, compiled for the shapes of the production network (see
:func:`takes_streamed`); the staged kernel for every other jet whose row fits
one stage of shared memory (:func:`takes_staged`: every ``D = 256`` jet up to
``C = 64``, with or without a residual); and the generic one for what is left,
``D > 512``, a row past one stage or a field off the 16-byte grid.

:func:`layernorm_jet` runs a kernel for CUDA tensors and the plain version
(:func:`layernorm_jet_plain`, the primitive chain of
``deephall_tpu/networks/fwdlap.py:_layernorm``) for CPU tensors.  A CUDA jet
that no kernel takes raises before any launch.  ``layernorm_jet.launches``
counts launches of any of the kernels, ``layernorm_jet.launches_streamed`` and
``layernorm_jet.launches_staged`` those of the streamed and the staged one.
:func:`layernorm_jet_generic` launches the generic kernel on any jet that
:func:`check_shape` passes, so that it can be timed beside the others.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from deephall_tpu_torch.ops import fwdlap
from deephall_tpu_torch.ops._build import check, function, require, stream
from deephall_tpu_torch.ops.fwdlap import Jet

MAX_TANGENTS = 64  # C, the largest register capacity of the generic kernel (N <= 30 with L^2)
MAX_EXTRAS = 4  # E
STREAMED_FEAT = 256  # the shapes the streamed kernel is compiled for
STREAMED_MODES = ((15, 3), (13, 1))  # (C, E): with L^2, without


def takes_streamed(feat: int, c: int, e: int, residual: bool, rows: int, aligned: bool) -> bool:
    """Whether the streamed kernel takes this jet; the others take the rest.

    It is compiled for ``D = 256`` and the two jet modes of the production
    network, always adds a residual, and moves 16 bytes at a time: ``aligned``
    says that every field's address is a multiple of 16.  Any row count will do.
    """
    return (
        feat == STREAMED_FEAT and (c, e) in STREAMED_MODES and residual and rows > 0 and aligned
    )


def stage_bytes(feat: int, c: int, e: int, residual: bool) -> int:
    """Bytes of one stage of the staged kernel: a row's ``C + E + 2`` planes of
    ``D`` floats, and the residual's."""
    return (2 if residual else 1) * (c + e + 2) * feat * 4


@functools.cache
def staged_stages(device: int, feat: int, c: int, e: int, residual: bool) -> int:
    """The stages of the staged kernel's ring for this jet on CUDA device
    ``device``, 0 where the kernel does not take it.

    The library answers (``csrc/jet_layernorm.cu:jet_layernorm_staged_stages``)
    from the device's shared memory a block, so the routing rule and the launch
    share one budget.  It needs the card.
    """
    fn = function("jet_layernorm", "jet_layernorm_staged_stages", (ctypes.c_int,) * 5)
    return fn(device, feat, c, e, int(residual))


def takes_staged(rows: int, aligned: bool, stages: int) -> bool:
    """Whether the staged kernel takes this jet (when the streamed one does not).

    A row's planes arrive by bulk copies of ``D`` floats into one stage of
    shared memory: it takes a jet whose ring holds a stage (``stages``, from
    :func:`staged_stages`: every jet with ``D <= 512`` whose row fits one),
    with or without a residual, whose fields all lie on the 16-byte grid
    (``aligned``).  Any row count will do.
    """
    return aligned and rows > 0 and stages >= 1


def route(feat: int, c: int, e: int, residual: bool, rows: int, aligned: bool,
          stages: int) -> str:
    """The kernel that takes a jet which :func:`check_shape` passes: ``"streamed"``,
    ``"staged"`` or ``"generic"``; ``stages`` as :func:`takes_staged`."""
    if takes_streamed(feat, c, e, residual, rows, aligned):
        return "streamed"
    if takes_staged(rows, aligned, stages):
        return "staged"
    return "generic"


def layernorm_jet_plain(p: dict, t: Jet, eps: float = 1e-5, residual: Jet | None = None) -> Jet:
    """``LN(t + residual)`` as a chain of jet primitives."""
    if residual is not None:
        t = fwdlap.add(t, residual)
    mean = fwdlap.linear(lambda v: v.mean(dim=-1, keepdim=True), t)
    xc = Jet(t.x - mean.x, t.j - mean.j, t.l - mean.l, t.d - mean.d)
    var = fwdlap.linear(
        lambda v: v.mean(dim=-1, keepdim=True), fwdlap.elementwise(fwdlap.square, xc)
    )
    rs = fwdlap.elementwise(fwdlap.rsqrt_eps(eps), var)
    x_hat = fwdlap.bilinear(lambda a, b: a * b, xc, rs)
    return fwdlap.linear(lambda v: v * p["scale"], x_hat, bias=p["bias"])


_PTR = ctypes.c_void_p
_ARGTYPES = (_PTR,) * 14 + (
    ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float, _PTR,
)


def check_shape(feat: int, c: int, e: int) -> None:
    """Raise ``ValueError`` for a jet that no kernel takes: the generic kernel,
    which takes what the other two do not, needs ``D % 32 == 0``,
    ``D <= 1024``, ``1 <= E <= MAX_EXTRAS`` and ``E <= C <= MAX_TANGENTS``."""
    if feat % 32 or not 0 < feat <= 1024:
        raise ValueError(f"feature width {feat}: the kernel needs D % 32 == 0 and D <= 1024")
    if not (1 <= e <= MAX_EXTRAS and e <= c <= MAX_TANGENTS):
        raise ValueError(
            f"(C, E) = ({c}, {e}): the kernel needs 1 <= E <= MAX_EXTRAS = {MAX_EXTRAS} "
            f"and E <= C <= MAX_TANGENTS = {MAX_TANGENTS}"
        )


def _check_jet(t: Jet, shape, j_shape, d_shape, device, what: str) -> None:
    for name, v, want in zip(Jet._fields, t, (shape, j_shape, shape, d_shape)):
        require(v, device, want, f"{what}.{name}")


def _launch(p: dict, t: Jet, eps: float, residual: Jet | None, kernel: str | None) -> Jet:
    """Check a CUDA jet, pick its kernel (``kernel`` ``"generic"`` forces the
    one-block-a-row kernel) and launch it; count the launch."""
    device = t.x.device
    shape = tuple(t.x.shape)
    c, e = t.j.shape[0], t.d.shape[0]
    feat = shape[-1]
    rows = t.x.numel() // feat
    j_shape, d_shape = (c, *shape), (e, *shape)
    _check_jet(t, shape, j_shape, d_shape, device, "t")
    if residual is not None:
        _check_jet(residual, shape, j_shape, d_shape, device, "residual")
    check_shape(feat, c, e)
    scale, bias = p["scale"], p["bias"]
    require(scale, device, (feat,), "scale")
    require(bias, device, (feat,), "bias")

    out = torch.empty((c + e + 2, *shape), dtype=torch.float32, device=device)
    ox, oj, ol, od = out[0], out[1 : 1 + c], out[1 + c], out[2 + c :]
    res = residual if residual is not None else (None,) * 4
    ptrs = [v.data_ptr() if v is not None else None for v in (*t, *res)]
    ptrs += [v.data_ptr() for v in (scale, bias, ox, oj, ol, od)]
    aligned = all(ptr is None or ptr % 16 == 0 for ptr in ptrs)
    if kernel is None:
        stages = staged_stages(device.index, feat, c, e, residual is not None)
        kernel = route(feat, c, e, residual is not None, rows, aligned, stages)
    symbol = f"jet_layernorm_{kernel}_f32"
    status = function("jet_layernorm", symbol, _ARGTYPES)(
        *ptrs, rows, feat, c, e, eps, stream(device)
    )
    check(status, symbol)
    layernorm_jet.launches += 1
    layernorm_jet.launches_streamed += kernel == "streamed"
    layernorm_jet.launches_staged += kernel == "staged"
    return Jet(ox, oj, ol, od)


def layernorm_jet(p: dict, t: Jet, eps: float = 1e-5, residual: Jet | None = None) -> Jet:
    """``LN(t + residual)`` of a jet with its feature axis last.

    Args:
        p: ``{"scale": [D], "bias": [D]}``.
        t: jet with ``x: [*S, D]``, ``j: [C, *S, D]``, ``l: [*S, D]``, ``d: [E, *S, D]``.
        eps: variance epsilon.
        residual: optional jet of the same shapes, added first.

    Returns:
        The normalised jet; on CUDA its four fields are views of one
        ``[C + E + 2, *S, D]`` buffer in the plane order x, j, l, d.
    """
    if t.x.device.type == "cpu":
        return layernorm_jet_plain(p, t, eps, residual)
    return _launch(p, t, eps, residual, None)


def layernorm_jet_generic(p: dict, t: Jet, eps: float = 1e-5, residual: Jet | None = None) -> Jet:
    """:func:`layernorm_jet` through the generic kernel whatever the shape (the
    plain version on the CPU): for timing it beside the kernel the routing picks."""
    if t.x.device.type == "cpu":
        return layernorm_jet_plain(p, t, eps, residual)
    return _launch(p, t, eps, residual, "generic")


layernorm_jet.launches = 0
layernorm_jet.launches_streamed = 0
layernorm_jet.launches_staged = 0
