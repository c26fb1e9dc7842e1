"""The Psiformer's log psi on the monopole sphere, in plain PyTorch.

The network of DeepHall (arXiv:2412.14795; the Psiformer of von Glehn et al.,
arXiv:2211.13672, on the sphere): input features (cos theta, sin theta cos
phi, sin theta sin phi, spin), ``layers`` blocks of multi-head self-attention
over the electrons, each followed by a residual LayerNorm, a tanh MLP and a
second residual LayerNorm; complex orbitals as learned features contracted
against the 2Q+1 monopole harmonics ``sqrt(C(2Q, Q-m)) u^(Q+m) v^(Q-m)``; a
Jastrow factor ``exp(J / N)`` on chord distances; and the log of the sum of
determinants.  The determinant is an LU elimination with partial pivoting
written out in tensor operations, so it differentiates to any order.

Parameters are ``{dotted.name: tensor}`` in the stored run's names; every
product runs in the dtype of the walkers.  With ``capture`` a dict, each
dense layer and LayerNorm records ``(input, output)`` as 2-D tensors with a
row per (walker, electron), keyed by its path joined with ``/`` (what KFAC's
curvature blocks are built from).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class Spec(NamedTuple):
    nspins: tuple[int, int]
    flux: int
    heads: int
    layers: int


def lu_logdet(a: torch.Tensor) -> torch.Tensor:
    """Complex ``log det a`` over the last two axes by elimination with partial
    pivoting; the phase is taken modulo 2 pi."""
    swaps = torch.zeros(a.shape[:-2], dtype=torch.int64, device=a.device)
    logdet = torch.zeros(a.shape[:-2], dtype=a.dtype, device=a.device)
    while a.shape[-1] > 1:
        m = a.shape[-1]
        pivot = a[..., :, 0].abs().detach().argmax(dim=-1)
        swaps = swaps + (pivot != 0)
        order = torch.arange(m, device=a.device).expand(*a.shape[:-2], m).clone()
        order.scatter_(-1, pivot[..., None], 0)
        order[..., 0] = pivot
        a = torch.gather(a, -2, order[..., :, None].expand(a.shape))
        head = a[..., 0, 0]
        logdet = logdet + torch.log(head)
        factor = a[..., 1:, 0] / head[..., None]
        a = a[..., 1:, 1:] - factor[..., :, None] * a[..., 0, None, 1:]
    logdet = logdet + torch.log(a[..., 0, 0])
    return logdet + 1j * math.pi * (swaps % 2).to(logdet.real.dtype)


def _dense(params, path, x, capture, bias=True):
    name = path.replace("/", ".")
    kernel = params[f"{name}.kernel"].to(x.dtype)
    x2d = x.reshape(-1, x.shape[-1])
    y2d = x2d @ kernel.reshape(x2d.shape[-1], -1)
    if bias:
        y2d = y2d + params[f"{name}.bias"].to(x.dtype).reshape(-1)
    if capture is not None:
        capture[path] = (x2d, y2d)
    return y2d


def _layernorm(params, path, x, capture):
    name = path.replace("/", ".")
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    x_hat = ((x - mean) / torch.sqrt(var + 1e-5)).reshape(-1, x.shape[-1])
    y2d = x_hat * params[f"{name}.scale"].to(x.dtype) + params[f"{name}.bias"].to(x.dtype)
    if capture is not None:
        capture[path] = (x_hat, y2d)
    return y2d.reshape(x.shape)


def _attention(params, path, h, heads, capture):
    batch = h.shape[:-1]
    dh = h.shape[-1] // heads
    q, k, v = (_dense(params, f"{path}/{p}", h, capture).reshape(*batch, heads, dh)
               for p in ("query", "key", "value"))
    logits = torch.einsum("...thd,...shd->...tsh", q / math.sqrt(dh), k)
    weights = torch.softmax(logits, dim=-2)
    attn = torch.einsum("...tsh,...shd->...thd", weights, v)
    return _dense(params, f"{path}/out", attn.reshape(*batch, heads * dh), capture).reshape(h.shape)


def _envelope(theta, phi, flux):
    """``[..., N, 2Q+1]`` complex monopole harmonics at each electron."""
    a = torch.arange(flux + 1, dtype=theta.dtype, device=theta.device)
    b = flux - a
    norm = torch.tensor([math.sqrt(math.comb(flux, int(k))) for k in range(flux + 1)],
                        dtype=theta.dtype, device=theta.device)
    mag = norm * torch.cos(theta / 2)[..., None] ** a * torch.sin(theta / 2)[..., None] ** b
    return torch.polar(mag, 0.5 * (a - b) * phi[..., None])


def _jastrow(params, theta, phi, nspins):
    xyz = torch.stack([torch.sin(theta) * torch.cos(phi), torch.sin(theta) * torch.sin(phi),
                       torch.cos(theta)], dim=-1)
    up, down = nspins
    groups = [(list(range(up)), list(range(up)), "ee_par", 0.25),
              (list(range(up, up + down)), list(range(up, up + down)), "ee_par", 0.25),
              (list(range(up)), list(range(up, up + down)), "ee_anti", 0.5)]
    total = torch.zeros(theta.shape[:-1], dtype=theta.dtype, device=theta.device)
    for left, right, name, c in groups:
        pairs = [(i, j) for i in left for j in right if i < j]
        if not pairs:
            continue
        i, j = (torch.tensor(v, device=theta.device) for v in zip(*pairs))
        r = torch.sqrt(((xyz[..., i, :] - xyz[..., j, :]) ** 2).sum(-1))
        alpha = params[f"Jastrow_0.{name}"].to(theta.dtype)
        total = total + (-(c * alpha**2) / (alpha + r)).sum(-1)
    return total


def orbital_matrices(params, spec: Spec, x: torch.Tensor, capture=None) -> torch.Tensor:
    """``[..., ndet, N, N]`` complex orbitals with the Jastrow factor folded in."""
    theta, phi = x[..., 0], x[..., 1]
    nelec = sum(spec.nspins)
    spins = torch.tensor([1.0] * spec.nspins[0] + [-1.0] * spec.nspins[1],
                         dtype=x.dtype, device=x.device)
    h = torch.stack([torch.cos(theta), torch.sin(theta) * torch.cos(phi),
                     torch.sin(theta) * torch.sin(phi), spins.expand(theta.shape)], dim=-1)
    tower = "PsiformerLayers_0"
    h = _dense(params, f"{tower}/Dense_0", h, capture, bias=False).reshape(*x.shape[:-1], -1)
    for i in range(spec.layers):
        attn = _attention(params, f"{tower}/MultiHeadAttention_{i}", h, spec.heads, capture)
        h = h + _dense(params, f"{tower}/Dense_{2 * i + 1}", attn, capture, bias=False).reshape(h.shape)
        h = _layernorm(params, f"{tower}/LayerNorm_{2 * i}", h, capture)
        h = h + torch.tanh(_dense(params, f"{tower}/Dense_{2 * i + 2}", h, capture).reshape(h.shape))
        h = _layernorm(params, f"{tower}/LayerNorm_{2 * i + 1}", h, capture)
    sectors, index, start = [], 0, 0
    for n in spec.nspins:
        if not n:
            continue
        part = h[..., start:start + n, :]
        start += n
        re, im = (_dense(params, f"Orbitals_0/featured_orbitals/DenseGeneral_{index + k}", part,
                         capture) for k in (0, 1))
        index += 2
        shape = (*part.shape[:-1], spec.flux + 1, nelec, -1)
        sectors.append(torch.complex(re.reshape(shape), im.reshape(shape)))
    features = torch.cat(sectors, dim=-4)  # [..., N, 2Q+1, N, ndet]
    orbitals = torch.einsum("...ifkd,...if->...dik", features, _envelope(theta, phi, spec.flux))
    jastrow = _jastrow(params, theta, phi, spec.nspins)
    return torch.exp(jastrow / nelec)[..., None, None, None] * orbitals


def logpsi(params, spec: Spec, x: torch.Tensor, capture=None) -> torch.Tensor:
    """Complex ``log psi`` of configurations ``[..., N, 2]``."""
    logdets = lu_logdet(orbital_matrices(params, spec, x, capture))  # [..., ndet]
    shift = logdets.real.amax(dim=-1, keepdim=True).detach()
    return torch.log(torch.exp(logdets - shift).sum(-1)) + shift[..., 0]
