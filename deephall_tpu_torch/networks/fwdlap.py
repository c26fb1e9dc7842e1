"""Forward-Laplacian evaluation of the Psiformer log-wavefunction.

Port of the standard tower of ``deephall_tpu/networks/fwdlap.py:
psiformer_logpsi_jet``: it mirrors ``networks/psiformer.py`` op for op but
propagates second-order jets (:mod:`deephall_tpu_torch.ops.fwdlap`) through one
forward pass.  The jet LayerNorm, the jet attention and the orbital head
(:mod:`deephall_tpu_torch.ops.orbital_head`; the sparse orbitals as a full
head, :func:`full_head`) go to the hand-written kernels for CUDA tensors and
to their plain versions for CPU tensors.

The input functions (features, monopole envelope, Jastrow) are seeded with
closed-form first and second derivatives along the seed curves, where the
JAX package takes nested ``jax.jvp`` along straight lines in
``(theta, phi)``.  The envelope is taken in the gauge regular at each
electron's nearer pole (:func:`envelope_fn`), so the jet is that of
``log psi' = log psi - i Q sum_i s_i phi_i``; its primal differs from
``Psiformer.forward``'s by that phase.  The Jastrow factor is folded in
algebraically: ``log psi' = J + log sum det(Phi')``.  From the tower's output
jet to the determinants' the jet runs in the span ``orbitals``
(:mod:`deephall_tpu_torch.tracing`).
"""

from __future__ import annotations

import torch

from deephall_tpu_torch import tracing
from deephall_tpu_torch.config import OrbitalType
from deephall_tpu_torch.networks.blocks import envelope_exponents, jastrow_pairs
from deephall_tpu_torch.networks.psiformer import Psiformer, spin_values
from deephall_tpu_torch.ops import fwdlap, jet_attention, jet_layernorm, orbital_head
from deephall_tpu_torch.ops.fwdlap import Jet
from deephall_tpu_torch.utils import constant
from deephall_tpu_torch.weights import param_tree


def input_feature_fn(nspins):
    """Jets of the input features ``(cos t, sin t cos p, sin t sin p, spin)``:
    the point ``X`` itself, so its derivatives are the seeds' velocity and
    acceleration."""

    def fn(data, seeds):
        spins = constant(tuple(spin_values(nspins)), data.dtype, data.device)
        spins = torch.broadcast_to(spins, data.shape[:-1])[..., None]
        order = constant((2, 0, 1), torch.long, data.device)  # (z, x, y)
        return (
            torch.cat([seeds.x[..., order], spins], dim=-1),
            torch.cat([seeds.v[..., order], torch.zeros_like(seeds.v[..., :1])], dim=-1),
            torch.cat([seeds.a[..., order], torch.zeros_like(seeds.a[..., :1])], dim=-1),
        )

    return fn


def envelope_fn(flux: int):
    """Jets of the envelope in the gauge regular at each electron's nearer pole,
    ``env'_m = norm_m u^(Q+m) v^(Q-m) e^{-i s Q phi}``, ``[*B, N, 2Q+1]`` complex.

    ``s = fwdlap.hemisphere(theta)``.  In the north (``s = 1``) the envelope is
    ``norm p^a q^b`` with ``p = cos(t/2)``, ``q = sin(t/2) e^{-i phi}``,
    ``a = Q+m``, ``b = Q-m``; in the south ``p = sin(t/2)``,
    ``q = cos(t/2) e^{i phi}`` and the exponents swap.  Both ``p`` and ``q``
    are smooth functions of the point: with ``w = s z``, ``p^2 = (1 + w) / 2``
    and ``2 p q = x - i s y``, and ``p >= 1/sqrt(2)``.  So along a curve with
    velocity ``V`` and acceleration ``A``, with ``u = Dp/p = Dw / (4 p^2)``
    and ``u2 = D^2p/p = D^2w / (4 p^2) - u^2``,

        Dq   = (x - i s y)' / (2p) - q u
        D^2q = (x - i s y)'' / (2p) - 2 u Dq - q u2

    and the envelope's jets are sums of ``p^a q^(b-k)``, ``k = 0, 1, 2``,
    times these: no term divides by ``q``, ``sin theta`` or ``sin(t/2)``.
    ``log psi`` changes by the phase ``-i Q sum_i s_i phi_i``, for which the
    gauge terms of ``hamiltonian.forward_laplacian_local_energy`` account.
    """
    alpha, beta, norm = envelope_exponents(flux)

    def fn(data, seeds):
        theta, phi = data[..., 0, None], data[..., 1, None]
        s = fwdlap.hemisphere(theta)
        north = s > 0
        a = constant(tuple(alpha), data.dtype, data.device)
        b = constant(tuple(beta), data.dtype, data.device)
        pa, qa = torch.where(north, a, b), torch.where(north, b, a)  # powers of p and q
        half_c, half_s = torch.cos(theta / 2), torch.sin(theta / 2)
        p, r = torch.where(north, half_c, half_s), torch.where(north, half_s, half_c)

        mag = constant(tuple(norm.tolist()), data.dtype, data.device) * torch.pow(p, pa)

        def times_q_power(k):  # mag q^k, q = r e^{-i s phi}; k >= 0
            return torch.polar(mag * torch.pow(r, k), -s * k * phi)

        e0 = times_q_power(qa)
        e1 = qa * times_q_power(torch.clamp(qa - 1, min=0))
        e2 = qa * (qa - 1) * times_q_power(torch.clamp(qa - 2, min=0))
        q = torch.polar(r, -s * phi)
        v, acc = seeds.v, seeds.a
        inv_p2 = 1 / (p * p)
        u = s * v[..., 2, None] * (0.25 * inv_p2)
        u2 = s * acc[..., 2, None] * (0.25 * inv_p2) - u * u
        half_inv_p = 0.5 / p
        dq = torch.complex(v[..., 0, None], -s * v[..., 1, None]) * half_inv_p - q * u
        d2q = (torch.complex(acc[..., 0, None], -s * acc[..., 1, None]) * half_inv_p
               - 2 * u * dq - q * u2)
        first = pa * u * e0 + e1 * dq
        second = (e0 * (pa * (pa - 1) * u * u + pa * u2) + e1 * (2 * pa * u * dq + d2q)
                  + e2 * dq * dq)
        return e0, first, second

    return fn


def jastrow_fn(nspins, params: dict):
    """Jets of the Jastrow ``sum_pairs -c alpha^2 / (alpha + r_ij)`` on chord distances."""
    par, anti = jastrow_pairs(nspins)

    def fn(data, seeds):
        x, first, second = seeds
        value = torch.zeros(data.shape[:-2], dtype=data.dtype, device=data.device)
        d1 = torch.zeros(first.shape[:-2], dtype=data.dtype, device=data.device)
        d2 = torch.zeros_like(d1)
        for pairs, name, coef in ((par, "ee_par", 0.25), (anti, "ee_anti", 0.5)):
            if not pairs:
                continue
            i, j = (constant(v, torch.long, data.device) for v in zip(*pairs))
            delta = x[..., i, :] - x[..., j, :]
            ddelta = first[..., i, :] - first[..., j, :]
            d2delta = second[..., i, :] - second[..., j, :]
            r = torch.linalg.vector_norm(delta, dim=-1)
            dr = torch.sum(delta * ddelta, dim=-1) / r
            d2r = (torch.sum(ddelta * ddelta + delta * d2delta, dim=-1) - dr * dr) / r
            alpha = params[name]
            den = alpha + r
            g = -(coef * alpha**2) / den
            g1 = -g / den
            g2 = -2 * g1 / den
            value = value + g.sum(dim=-1)
            d1 = d1 + (g1 * dr).sum(dim=-1)
            d2 = d2 + (g2 * dr * dr + g1 * d2r).sum(dim=-1)
        return value, d1, d2

    return fn


def _dense(p: dict, t: Jet, use_bias: bool = True) -> Jet:
    kernel = p["kernel"]
    return fwdlap.linear(lambda v: v @ kernel, t, bias=p["bias"] if use_bias else None)


def _dense_planes(p: dict, t: Jet) -> Jet:
    """:func:`_dense` without a bias, each field's product written into one
    ``[P, *B, T, F]`` buffer in the attention's plane order, so that the
    attention reads the planes in place instead of stacking a copy."""
    kernel = p["kernel"]
    c = t.j.shape[0]
    out = t.x.new_empty((c + t.d.shape[0] + 2, *t.x.shape[:-1], kernel.shape[-1]))
    planes = Jet(out[0], out[1 : 1 + c], out[1 + c], out[2 + c :])
    for field, rows in zip(t, planes):
        torch.matmul(field, kernel, out=rows)
    return planes


def full_head(model: Psiformer, p: dict) -> dict:
    """The head's parameters ``p`` (``Orbitals_0``) as a full-orbital head's:
    for each spin sector a real and an imaginary ``DenseGeneral`` with kernel
    ``[D, 2Q+1, N, K]`` and bias ``[2Q+1, N, K]``.

    Full orbitals are that already.  The sparse orbitals lift eight features
    ``h W + b`` to the 2Q+1 harmonics by the real ``lll_weight`` ``(L, c)``:
    ``(h W + b) L + c = h (W L) + (b L + c)``, with ``c`` in the real parts'
    bias only, as the reference adds the real bias to the complex features."""
    if model.orbital_type == OrbitalType.full:
        return p["featured_orbitals"]
    lll, c = p["lll_weight"]["kernel"], p["lll_weight"]["bias"]
    dense = p["featured_orbitals"]

    def lifted(d: dict, bias: torch.Tensor | float) -> dict:
        return {"kernel": torch.einsum("dfnk,fm->dmnk", d["kernel"], lll),
                "bias": torch.einsum("fnk,fm->mnk", d["bias"], lll) + bias}

    head = {}
    for real, imaginary in orbital_head.dense_pairs(dense):
        head[real] = lifted(dense[real], c[:, None, None])
        head[imaginary] = lifted(dense[imaginary], 0.0)
    return head


def psiformer_logpsi_jet(
    model: Psiformer, data: torch.Tensor, compute_l2: bool = False, kernels: bool = True
) -> Jet:
    """Second-order jet of ``log psi`` at batched configurations ``[*B, N, 2]``.

    Args:
        model: the Psiformer (its parameters are read, not differentiated).
        data: ``[*B, N, 2]`` configurations.
        compute_l2: also carry the x/y L^2 directions (E = 3 instead of 1).
        kernels: route the jet LayerNorm, the attention and the orbital head
            through their wrappers, which launch the hand-written kernels for
            CUDA tensors.  ``False`` calls their plain versions on any device,
            to hold the kernel path against the plain path end to end.

    Returns:
        Scalar-per-walker :class:`Jet` of ``log psi'`` (the module docstring)
        seeded with :func:`fwdlap.electron_seeds`.
    """
    if kernels:
        layernorm, attention = jet_layernorm.layernorm_jet, jet_attention.attention_jet
    else:
        layernorm = jet_layernorm.layernorm_jet_plain
        attention = jet_attention.attention_jet_plain
    p = param_tree(model)
    extras = 3 if compute_l2 else 1
    seeds = fwdlap.electron_seeds(data, compute_l2)

    h0 = fwdlap.jet_of_fn(input_feature_fn(model.nspins), data, seeds, extras)
    env = fwdlap.jet_of_fn(envelope_fn(model.flux), data, seeds, extras)

    # Each intermediate jet is dropped as soon as it is used: at batch 3360 in
    # L^2 mode one [P, B, T, D] jet is 413 MB.
    tower = p["PsiformerLayers_0"]
    h = _dense_planes(tower["Dense_0"], h0)
    del h0
    for i in range(model.num_layers):
        attn = attention(tower[f"MultiHeadAttention_{i}"], model.num_heads, h)
        proj = _dense(tower[f"Dense_{2 * i + 1}"], attn, use_bias=False)
        del attn
        h = layernorm(tower[f"LayerNorm_{2 * i}"], h, residual=proj)
        del proj
        mlp = fwdlap.elementwise(fwdlap.tanh, _dense(tower[f"Dense_{2 * i + 2}"], h))
        h = layernorm(tower[f"LayerNorm_{2 * i + 1}"], h, residual=mlp)
        del mlp

    jastrow = fwdlap.jet_of_fn(
        jastrow_fn(model.nspins, p["Jastrow_0"]), data, seeds, extras
    )
    # The orbital head, the envelope contraction and the determinants.
    with tracing.span("orbitals"):
        head = orbital_head.orbital_matrices_jet if kernels else orbital_head.orbital_matrices_plain
        phi_jet = head(full_head(model, p["Orbitals_0"]), h, env, model.nspins)
        del h, env
        logdet = fwdlap.logsumdet_jet(phi_jet)
    return fwdlap.add(logdet, jastrow)
