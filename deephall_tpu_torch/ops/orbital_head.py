"""The orbital head's jet: hand-written CUDA kernel and plain version.

From the tower's output jet ``h`` (``x: [B, N, D]``, planes ``P = C + E + 2``)
and the envelope's jet ``env`` (``x: [B, N, 2Q+1]`` complex) this computes the
jet of the orbital matrices ``[B, K, N, N]`` (K determinants): the head's
complex projection ``o = h W + b`` (``W: [D, 2Q+1, N, K]``), contracted over
the harmonics with the envelope by ``fwdlap.bilinear``'s rule.  The feature
jet, ``P (2Q+1) N^2 K`` complex numbers a walker (28.9 GB at N = 10,
2Q = 27, 16 determinants and batch 3360), is never written whole: the kernel
keeps it on chip, and the plain version makes one plane of it at a time.

``csrc/orbital_head.cu:orbital_head_jet_kernel`` multiplies each plane's rows
by the kernel laid out as one real ``[D, 2F]`` matrix a (orbital,
determinant) pair (:func:`head_columns`: real and imaginary parts side by
side, pairs padded to :func:`column_plan`'s stride and grouped into column
tiles), as three TF32 products on the tensor cores, and contracts each row's
harmonics with the envelope in its epilogue.  The terms that pair features with the envelope's
own derivatives are computed only where that derivative is structurally
nonzero (direction ``2i`` or ``2i + 1`` moves electron ``i`` alone; the extra
rotations move every electron): the primal row against ``env.j`` of its
electron's two directions, every extra, ``env.l`` and ``env.d``; a tangent
row of its electron's own direction, or of an extra, against that
direction's ``env.j``, doubled.  These go to ``5 + 3E`` side planes, which
``orbital_head_jet_finish_kernel`` adds to the planes they belong to in a
fixed order: the primal's terms, direction ``2n``'s and the extras' cross
terms, direction ``2n + 1``'s.

:func:`orbital_matrices_jet` launches the kernel for CUDA tensors (one launch
a spin sector, then the finishing pass).  Where no column tile holds a pair's
harmonics (2Q+1 > :data:`MAX_HARMONICS`), the harmonics go through in
consecutive ranges of at most that many, a launch of the kernel each, and
their matrices are added: every term is a sum over the harmonics.  CPU
tensors take :func:`orbital_matrices_plain`, the same sums in the same order,
plane by plane.  Each call on the card is counted in
``orbital_matrices_jet.launches`` and as ``orbitals.fused`` in the open block
record (:func:`deephall_tpu_torch.tracing.count`), and each harmonic range's
launch as ``orbitals.range``: one a call where the harmonics fit a tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from deephall_tpu_torch import tracing
from deephall_tpu_torch.ops._build import check, function, require, stream
from deephall_tpu_torch.ops.fwdlap import Jet
from deephall_tpu_torch.ops.jet_attention import packed_planes, tf32_round

WIDTHS = (128, 112, 96, 64)  # the column tiles the kernel is compiled for
DEPTH_STEP = 32  # the kernel's K step: D % 32 == 0
MAX_HARMONICS = max(WIDTHS) // 2  # 2Q + 1 <= 64: a pair's stride fits one tile


class Plan(NamedTuple):
    """The kernel's columns: pairs of ``stride`` columns, ``per_tile`` to a
    tile of ``width`` columns, ``tiles`` tiles."""

    stride: int
    per_tile: int
    width: int
    tiles: int


def column_plan(harmonics: int, pairs: int) -> Plan:
    """The column tiling for ``pairs`` (orbital, determinant) pairs of
    ``harmonics`` complex features each: a pair's ``2F`` columns padded to a
    multiple of 8, as many whole pairs to a tile as fit, and the tile width of
    :data:`WIDTHS` that computes the fewest columns (the widest on a tie, for
    the fewest tiles)."""
    if not 0 < harmonics <= MAX_HARMONICS:
        raise ValueError(f"2Q+1 = {harmonics}: the kernel takes 1 to {MAX_HARMONICS} harmonics")
    stride = -(-2 * harmonics // 8) * 8
    plans = []
    for width in WIDTHS:
        per_tile = min(width // stride, pairs)
        if per_tile:
            tiles = -(-pairs // per_tile)
            plans.append((tiles * width, -width, Plan(stride, per_tile, width, tiles)))
    return min(plans)[2]


def head_columns(re: torch.Tensor, im: torch.Tensor, plan: Plan) -> torch.Tensor:
    """``re + i im`` of shape ``[..., F, N, K]`` as the kernel's real columns
    ``[..., tiles * width]``: pair ``g = k N + n`` of tile ``g // per_tile`` at
    column ``(g % per_tile) stride``, harmonic ``f``'s real part in column
    ``2f`` and its imaginary part in ``2f + 1``, zeros in the padding."""
    *lead, harmonics, nelec, ndet = re.shape
    pairs = nelec * ndet
    w = torch.stack([re, im], dim=-1)  # [..., F, N, K, 2]
    w = w.movedim(-4, -2).movedim(-4, -3)  # [..., K, N, F, 2]
    w = w.reshape(*lead, pairs, 2 * harmonics)
    w = torch.nn.functional.pad(w, (0, plan.stride - 2 * harmonics, 0,
                                    plan.tiles * plan.per_tile - pairs))
    w = w.reshape(*lead, plan.tiles, plan.per_tile * plan.stride)
    w = torch.nn.functional.pad(w, (0, plan.width - plan.per_tile * plan.stride))
    return w.reshape(*lead, plan.tiles * plan.width)


class HeadColumns(NamedTuple):
    """One spin sector's kernel for the launch: ``hi + lo ~ W^T`` ``[tiles
    width, D]``, each exactly representable in TF32, and the bias in the
    columns' layout ``[tiles width]`` (complex pairs of floats)."""

    hi: torch.Tensor
    lo: torch.Tensor
    bias: torch.Tensor
    plan: Plan


def split_columns(wr: dict, wi: dict) -> HeadColumns:
    """The real and imaginary ``DenseGeneral`` of a sector as :class:`HeadColumns`."""
    harmonics, nelec, ndet = wr["kernel"].shape[1:]
    plan = column_plan(harmonics, nelec * ndet)
    wt = head_columns(wr["kernel"], wi["kernel"], plan).t().contiguous()
    hi = tf32_round(wt)
    bias = head_columns(wr["bias"], wi["bias"], plan).contiguous()
    return HeadColumns(hi, tf32_round(wt - hi), bias, plan)


def side_planes(extras: int) -> int:
    """The kernel's side planes: the primal's ``3 + 2E`` terms (its electron's
    two directions, the extras, the Laplacian, the extras' second
    derivatives) and the ``2 + E`` cross terms."""
    return 5 + 3 * extras


def dense_pairs(p: dict) -> list[tuple[str, str]]:
    """The names of the head's ``(real, imaginary)`` ``DenseGeneral`` pairs,
    one a spin sector that has electrons, in the sectors' order."""
    return [(f"DenseGeneral_{i}", f"DenseGeneral_{i + 1}") for i in range(0, len(p), 2)]


def sectors(p: dict, nspins):
    """``(lo, hi, real, imaginary)`` of each spin sector's ``DenseGeneral`` pair."""
    bounds = [(lo, hi) for lo, hi in ((0, nspins[0]), (nspins[0], sum(nspins))) if hi > lo]
    for (lo, hi), (real, imaginary) in zip(bounds, dense_pairs(p)):
        yield lo, hi, p[real], p[imaginary]


def harmonic_ranges(harmonics: int) -> list[tuple[int, int]]:
    """The fewest consecutive, even ranges of the harmonics that each fit a
    column tile (at most :data:`MAX_HARMONICS`): one range of all of them
    when they fit."""
    count = max(1, -(-harmonics // MAX_HARMONICS))
    bounds = [i * harmonics // count for i in range(count + 1)]
    return list(zip(bounds, bounds[1:]))


def harmonic_slice(dense: dict, f0: int, f1: int) -> dict:
    """A ``DenseGeneral``'s harmonics ``f0`` to ``f1``: views."""
    return {"kernel": dense["kernel"][:, f0:f1], "bias": dense["bias"][f0:f1]}


def _one_batch_axis(fn, p: dict, h: Jet, env: Jet, nspins) -> Jet:
    """``fn`` on ``h`` and ``env`` with their batch axes flattened into one,
    the batch axes restored in its result."""
    lead = h.x.shape[:-2]

    def flat(t: Jet) -> Jet:
        return Jet(t.x.reshape(-1, *t.x.shape[-2:]),
                   t.j.reshape(t.j.shape[0], -1, *t.j.shape[-2:]),
                   t.l.reshape(-1, *t.l.shape[-2:]),
                   t.d.reshape(t.d.shape[0], -1, *t.d.shape[-2:]))

    out = fn(p, flat(h), flat(env), nspins)
    return Jet(out.x.reshape(*lead, *out.x.shape[1:]),
               out.j.reshape(out.j.shape[0], *lead, *out.j.shape[2:]),
               out.l.reshape(*lead, *out.l.shape[1:]),
               out.d.reshape(out.d.shape[0], *lead, *out.d.shape[2:]))


def orbital_matrices_plain(p: dict, h: Jet, env: Jet, nspins) -> Jet:
    """The orbital matrices' jet ``[B, K, N, N]`` as the kernel computes it,
    a plane of features at a time, its terms added in the kernel's order:
    each plane's projection against ``env.x``; the primal's against its
    electron's two tangents of the envelope, the extras', ``env.l`` and
    ``env.d``; the doubled cross terms of direction ``2n`` and of the extras;
    then those of direction ``2n + 1``.

    Args:
        p: the head's parameters (``Orbitals_0/featured_orbitals``): for each
            spin sector a real and an imaginary ``DenseGeneral`` with kernel
            ``[D, 2Q+1, N, K]`` and bias ``[2Q+1, N, K]``.
        h: the tower's output jet, ``x: [B, N, D]``.
        env: the envelope's jet, ``x: [B, N, 2Q+1]`` complex.
        nspins: the electrons of each spin.

    Batch axes other than one are flattened into one for the call.
    """
    if h.x.dim() != 3:
        return _one_batch_axis(orbital_matrices_plain, p, h, env, nspins)
    c, e = h.j.shape[0], h.d.shape[0]
    lap = c - e
    batch, nelec, _ = h.x.shape
    planes = [h.x, *h.j, h.l, *h.d]
    ndet = p["DenseGeneral_0"]["kernel"].shape[-1]
    out = torch.empty((len(planes), batch, ndet, nelec, nelec), dtype=env.x.dtype,
                      device=h.x.device)

    def contract(o, v):  # [B, n, F, N, K] x [B, n, F] -> [B, K, n, N]
        return torch.einsum("bnfed,bnf->bdne", o, v)

    def own(t, n):  # electron n's slice of [B, N, ...], the axis kept
        return t[:, n : n + 1]

    for lo, hi, wr, wi in sectors(p, nspins):
        rows = slice(lo, hi)
        kr, ki = wr["kernel"], wi["kernel"]
        feat = kr.shape[1:]
        kr, ki = kr.reshape(kr.shape[0], -1), ki.reshape(ki.shape[0], -1)
        bias = torch.complex(wr["bias"], wi["bias"])
        cross = {}  # the doubled cross terms, by direction: [B, K, n, N]
        for index, a in enumerate(planes):
            o = torch.complex(a[:, rows] @ kr, a[:, rows] @ ki).reshape(batch, hi - lo, *feat)
            if index == 0:
                primal = o = o + bias
            out[index, :, :, rows] = contract(o, env.x[:, rows])
            k = index - 1
            if 0 <= k < lap and lo <= k // 2 < hi:
                cross[k] = 2 * contract(own(o, k // 2 - lo), own(env.j[k], k // 2))
            elif lap <= k < c:
                cross[k] = 2 * contract(o, env.j[k, :, rows])
        for n in range(lo, hi):  # the primal against its electron's own tangents
            for s in range(2):
                out[1 + 2 * n + s, :, :, n : n + 1] += contract(
                    own(primal, n - lo), own(env.j[2 * n + s], n))
        for x in range(e):
            out[1 + lap + x, :, :, rows] += contract(primal, env.j[lap + x, :, rows])
        out[1 + c, :, :, rows] += contract(primal, env.l[:, rows])
        for x in range(e):
            out[2 + c + x, :, :, rows] += contract(primal, env.d[x, :, rows])
        for n in range(lo, hi):  # direction 2n's cross terms, and the extras'
            out[1 + c, :, :, n : n + 1] += cross[2 * n]
        for x in range(e):
            out[2 + c + x, :, :, rows] += cross[lap + x]
        for n in range(lo, hi):  # direction 2n + 1's
            out[1 + c, :, :, n : n + 1] += cross[2 * n + 1]
    return Jet(out[0], out[1 : 1 + c], out[1 + c], out[2 + c :])


_PTR = ctypes.c_void_p
_ARGTYPES = (_PTR,) * 10 + (ctypes.c_int,) * 12 + (_PTR,)
_FINISH_ARGTYPES = (_PTR, _PTR, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int, _PTR)


def _check(h: Jet, env: Jet, nelec: int) -> None:
    device = h.x.device
    batch, _, depth = h.x.shape
    c, e = h.j.shape[0], h.d.shape[0]
    harmonics = env.x.shape[-1]
    for name, v, want in zip(Jet._fields, h, ((batch, nelec, depth), (c, batch, nelec, depth),
                                              (batch, nelec, depth), (e, batch, nelec, depth))):
        require(v, device, want, f"h.{name}")
    for name, v, want in zip(Jet._fields, env, ((batch, nelec, harmonics),
                                                (c, batch, nelec, harmonics),
                                                (batch, nelec, harmonics),
                                                (e, batch, nelec, harmonics))):
        if v.device != device or v.dtype != torch.complex64 or tuple(v.shape) != want:
            raise TypeError(f"env.{name}: need complex64 {want} on {device}, got "
                            f"{v.dtype} {tuple(v.shape)} on {v.device}")
    if c - e != 2 * nelec or e < 1:
        raise ValueError(f"(C, E) = ({c}, {e}): need C - E = 2N = {2 * nelec} and E >= 1")
    if depth % DEPTH_STEP:
        raise ValueError(f"feature width {depth}: the kernel needs D % {DEPTH_STEP} == 0")


def _launch(columns: list, stacked: torch.Tensor, env: Jet, c: int, e: int,
            out: torch.Tensor, side: torch.Tensor) -> None:
    """The kernel's launches into ``out`` (``[P, B, K, N, N]``, each matrix
    transposed), one for each spin sector's ``(lo, hi, HeadColumns)``, then
    the finishing pass."""
    device = stacked.device
    _, batch, nelec, depth = stacked.shape
    ndet = out.shape[2]
    launch = function("orbital_head", "orbital_head_jet_f32", _ARGTYPES)
    for lo, hi, cols in columns:
        plan = cols.plan
        status = launch(
            stacked.data_ptr(), cols.hi.data_ptr(), cols.lo.data_ptr(), cols.bias.data_ptr(),
            *(v.data_ptr() for v in env), out.data_ptr(), side.data_ptr(),
            batch, nelec, lo, hi - lo, depth, env.x.shape[-1], plan.stride, plan.per_tile,
            plan.width, ndet, c, e, stream(device),
        )
        check(status, "orbital_head_jet")
    status = function("orbital_head", "orbital_head_jet_finish_f32", _FINISH_ARGTYPES)(
        out.data_ptr(), side.data_ptr(), out[0].numel(), nelec, c, e, stream(device))
    check(status, "orbital_head_jet_finish")


def orbital_matrices_jet(p: dict, h: Jet, env: Jet, nspins) -> Jet:
    """The jet of the orbital matrices ``[B, K, N, N]`` (complex; planes in the
    jet's order x, j, l, d), by :func:`orbital_matrices_plain`'s arguments.
    CPU tensors take the plain version.  CUDA tensors take the kernel, and
    then the fields are views of one ``[P, B, K, N, N]`` buffer that holds
    each matrix transposed; more than :data:`MAX_HARMONICS` harmonics take a
    launch for each of :func:`harmonic_ranges`, added into that buffer; what
    the kernel does not take raises a ``TypeError`` / ``ValueError`` naming
    it.  Batch axes other than one are flattened into one for the call."""
    if h.x.device.type == "cpu":
        return orbital_matrices_plain(p, h, env, nspins)
    if h.x.dim() != 3:
        return _one_batch_axis(orbital_matrices_jet, p, h, env, nspins)
    device = h.x.device
    nelec = sum(nspins)
    env = Jet(*(v.contiguous() for v in env))
    _check(h, env, nelec)
    c, e = h.j.shape[0], h.d.shape[0]
    planes = c + e + 2
    batch = h.x.shape[0]
    stacked = packed_planes(h)
    if stacked is None:
        stacked = torch.cat([h.x[None], h.j, h.l[None], h.d], dim=0)
    ranges = harmonic_ranges(env.x.shape[-1])
    columns = [[(lo, hi, split_columns(harmonic_slice(wr, f0, f1), harmonic_slice(wi, f0, f1)))
                for lo, hi, wr, wi in sectors(p, nspins)] for f0, f1 in ranges]
    ndet = p["DenseGeneral_0"]["kernel"].shape[-1]
    # Each matrix transposed (the electron last): the lanes of consecutive rows
    # store consecutive values.
    out = torch.empty((planes, batch, ndet, nelec, nelec), dtype=torch.complex64, device=device)
    side = torch.empty((side_planes(e), *out.shape[1:]), dtype=torch.complex64, device=device)
    part = out
    for index, (f0, f1) in enumerate(ranges):
        if index == 1:
            part = torch.empty_like(out)
        _launch(columns[index], stacked, Jet(*(v[..., f0:f1].contiguous() for v in env)),
                c, e, part, side)
        tracing.count("orbitals.range")
        if index:
            out += part
    del part
    orbital_matrices_jet.launches += 1
    tracing.count("orbitals.fused")
    out = out.transpose(-1, -2)
    return Jet(out[0], out[1 : 1 + c], out[1 + c], out[2 + c :])


orbital_matrices_jet.launches = 0
