"""One VMC iteration after the sweep, in plain PyTorch: the energy statistics,
the penalties, the clipped energy gradient and the KFAC step.

DeepHall's loss (arXiv:2412.14795; FermiNet's clipped-energy gradient): the
local energies' real and imaginary parts clipped to the median window
``[q1 - 100 IQR, q3 + 100 IQR]``, the per-walker weights ``2 (E_L - <E_clip>)
/ n`` clipped again after the penalties (Lz^2 about ``lz_center``, L^2 above
``l2_center``, the overlap with fixed lower states), and the gradient of
``sum_i Re(w_i) Re log psi_i + Im(w_i) Im log psi_i``.

KFAC (Martens and Grosse 2015) as DeepHall configures it: Kronecker blocks
``A (x) G`` of every dense layer (inputs with a ones column for a bias; the
sensitivities of ``sqrt(2) Re log psi``), diagonal blocks for the LayerNorms,
the identity for the Jastrow cusps; the EMA of the factors, pi-split
damping, ``sqrt(T)`` scaling of a layer whose walker contributes ``T`` rows,
the learning rate ``rate / (1 + step / delay)`` and the norm constraint
``min(1, sqrt(c / (lr^2 d^T F d)))``.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference import psiformer

PENALTY_KEYS = ("lz_penalty", "lz_center", "l2_penalty", "l2_center", "overlap_penalty")


def _nanmean(x: torch.Tensor, dim=None) -> torch.Tensor:
    valid = ~torch.isnan(x)
    kw = {} if dim is None else {"dim": dim, "keepdim": True}
    return torch.where(valid, x, torch.zeros_like(x)).sum(**kw) / valid.sum(**kw)


def _clip_real(x: torch.Tensor, scale: float = 100.0) -> torch.Tensor:
    q1, q3 = torch.nanquantile(x, 0.25), torch.nanquantile(x, 0.75)
    return torch.clamp(x, q1 - scale * (q3 - q1), q3 + scale * (q3 - q1))


def _clip(x: torch.Tensor) -> torch.Tensor:
    return torch.complex(_clip_real(x.real), _clip_real(x.imag))


def stats_and_diff(system: dict, obs: dict, log_ratios: torch.Tensor | None = None):
    """``(stats, diff)``: the logged means and the clipped per-walker weights'
    numerators.  ``system`` holds ``compute_l2``, ``l2_adaptive``,
    ``dynamic_penalties`` and the penalty values; ``log_ratios`` is ``[S, B]``
    ``log(phi_j / psi)`` against the fixed lower states."""
    el = obs["energy"]
    keys = ("kinetic", "potential", "angular_momentum_z", "angular_momentum_z_square")
    stats = {k: _nanmean(obs[k]) for k in keys}
    if system["compute_l2"]:
        stats["angular_momentum_square"] = _nanmean(obs["angular_momentum_square"])
    loss = _nanmean(el)
    diff = el - _nanmean(_clip(el))
    dynamic = system["dynamic_penalties"]
    if log_ratios is not None:
        real = log_ratios.real
        shift = torch.where(torch.isnan(real), -torch.inf, real).amax(dim=1, keepdim=True)
        shift = torch.where(torch.isfinite(shift), shift, torch.zeros_like(shift))
        rho = torch.exp(log_ratios - shift)
        mean = _nanmean(rho, dim=1)
        norm = _nanmean(rho.abs() ** 2, dim=1)
        overlap = mean.abs() ** 2 / norm
        diff = diff + (system["overlap_penalty"] * (mean.conj() * rho / norm - overlap)).sum(0)
        stats["overlap"] = overlap.sum()
    k_eff = None
    if (dynamic and system["compute_l2"]) or system["l2_penalty"]:
        l2 = obs["angular_momentum_square"]
        mean_l2 = _nanmean(_clip_real(l2))
        if system["l2_adaptive"]:
            k_eff = system["l2_penalty"] * torch.clamp(mean_l2 - system["l2_center"], 0.0, 1.0)
        else:
            k_eff = system["l2_penalty"] * (mean_l2 > system["l2_center"]).to(l2.dtype)
        diff = diff + k_eff * (l2 - mean_l2)
    if dynamic or system["lz_penalty"]:
        lz_penalty = torch.tensor(float(system["lz_penalty"]), dtype=el.real.dtype, device=el.device)
        if system["l2_adaptive"] and k_eff is not None:
            lz_penalty = torch.maximum(lz_penalty, 3.0 * system["lz_center"] * k_eff)
        lz2, lz = obs["angular_momentum_z_square"], obs["angular_momentum_z"]
        diff = diff + lz_penalty * ((lz2 - _nanmean(_clip_real(lz2)))
                                    - 2 * system["lz_center"] * (lz - _nanmean(_clip_real(lz))))
    diff = _clip(diff)
    stats["energy"] = loss
    stats["variance"] = _nanmean(el.real**2) - loss.real**2
    return stats, diff


def weights(diff: torch.Tensor) -> torch.Tensor:
    valid = ~torch.isnan(diff)
    count = torch.clamp(valid.sum(), min=1)
    return torch.where(valid, torch.nan_to_num(diff), torch.zeros_like(diff)) * (2.0 / count)


def gradient_and_curvature(params: dict, spec: psiformer.Spec, x: torch.Tensor, w: torch.Tensor):
    """``(grads, capture, dy)``: the energy gradient of every leaf, each layer's
    recorded ``(input, output)`` and the Fisher sensitivities of its output."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    capture: dict = {}
    with torch.enable_grad():
        f = psiformer.logpsi(leaves, spec, x, capture)
        out = (f.real * w.real + f.imag * w.imag).sum()
        grads = torch.autograd.grad(out, list(leaves.values()), retain_graph=True, allow_unused=True)
        paths = list(capture)
        dy = torch.autograd.grad((math.sqrt(2.0) * f.real).sum(), [capture[p][1] for p in paths])
    grads = {k: torch.zeros_like(v) if g is None else torch.nan_to_num(g)
             for (k, v), g in zip(leaves.items(), grads)}
    return grads, {p: capture[p][0].detach() for p in paths}, dict(zip(paths, dy))


def kfac_step(params: dict, curvature: dict, grads: dict, inputs: dict, dy: dict,
              batch: int, kfac: dict):
    """One KFAC step from the curvature ``{kron, diag, weight, step}``: returns
    ``(new params, new curvature, info)``."""
    ema, damping = kfac["curvature_ema"], kfac["damping"]
    kron, diag = {}, {}
    for path, a in inputs.items():
        g = dy[path]
        rows = a.shape[0]
        if path.split("/")[-1].startswith("LayerNorm"):
            a3 = a.reshape(batch, rows // batch, -1)
            g3 = g.reshape(batch, rows // batch, -1)
            diag[path] = {"scale": ((g3 * a3).sum(1) ** 2).mean(0), "bias": (g3.sum(1) ** 2).mean(0)}
        else:
            if f"{path.replace('/', '.')}.bias" in params:
                a = torch.cat([a, torch.ones_like(a[:, :1])], dim=1)
            kron[path] = {"a": a.T @ a / rows, "g": g.T @ g / rows}
    new = {
        "kron": {p: {f: ema * v + (1 - ema) * kron[p][f] for f, v in b.items()}
                 for p, b in curvature["kron"].items()},
        "diag": {p: {f: ema * v + (1 - ema) * diag[p][f] for f, v in b.items()}
                 for p, b in curvature["diag"].items()},
        "weight": ema * curvature["weight"] + (1 - ema),
        "step": curvature["step"] + 1,
    }
    weight = max(float(new["weight"]), 1e-8)
    deltas, quad = {}, 0.0
    for path, block in new["kron"].items():
        name = path.replace("/", ".")
        repeats = inputs[path].shape[0] // batch
        a_mat = block["a"] / weight * math.sqrt(repeats)
        g_mat = block["g"] / weight * math.sqrt(repeats)
        pi = math.sqrt(max(float(torch.trace(a_mat)) / a_mat.shape[0], 1e-20)
                       / max(float(torch.trace(g_mat)) / g_mat.shape[0], 1e-20))
        a_d = a_mat + math.sqrt(damping) * pi * torch.eye(a_mat.shape[0], dtype=a_mat.dtype, device=a_mat.device)
        g_d = g_mat + math.sqrt(damping) / pi * torch.eye(g_mat.shape[0], dtype=g_mat.dtype, device=g_mat.device)
        kernel = grads[f"{name}.kernel"]
        gmat = kernel.reshape(-1, g_mat.shape[0])
        has_bias = f"{name}.bias" in grads
        if has_bias:
            gmat = torch.cat([gmat, grads[f"{name}.bias"].reshape(1, -1)], dim=0)
        delta = torch.linalg.solve(g_d, torch.linalg.solve(a_d, gmat).T).T
        quad += float((delta * (a_d @ delta @ g_d)).sum())
        if has_bias:
            deltas[f"{name}.bias"] = delta[-1].reshape(grads[f"{name}.bias"].shape)
            delta = delta[:-1]
        deltas[f"{name}.kernel"] = delta.reshape(kernel.shape)
    for path, block in new["diag"].items():
        name = path.replace("/", ".")
        for leaf in ("scale", "bias"):
            d = block[leaf] / weight + damping
            delta = grads[f"{name}.{leaf}"] / d
            quad += float((delta * d * delta).sum())
            deltas[f"{name}.{leaf}"] = delta
    for name, g in grads.items():
        if name not in deltas:
            deltas[name] = g / damping
            quad += float((deltas[name] * damping * deltas[name]).sum())
    lr = kfac["rate"] * (1.0 / (1.0 + float(curvature["step"]) / kfac["delay"])) ** kfac["decay"]
    coeff = min(math.sqrt(kfac["norm_constraint"] / max(lr**2 * quad, 1e-20)), 1.0)
    new_params = {k: v - lr * coeff * deltas[k] for k, v in params.items()}
    return new_params, new, {"learning_rate": lr, "norm_coefficient": coeff, "quadratic_norm": quad}
