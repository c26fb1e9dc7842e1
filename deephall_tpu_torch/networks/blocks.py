"""Neural building blocks (port of ``deephall_tpu/networks/blocks.py``).

Every module keeps the flax parameter names and shapes of the JAX package, so a
checkpoint's parameter tree maps one to one onto the module state
(:mod:`deephall_tpu_torch.weights`): ``DenseGeneral`` kernels are
``(*contracted_dims, *features)``, attention projections are named
``query``/``key``/``value``/``out``, and so on.

KFAC curvature capture: inside :func:`kfac_capture`, every ``Dense``,
``DenseGeneral`` and ``LayerNorm`` records its folded 2-D input ``x2d``
(``x_hat`` before scale and bias for ``LayerNorm``) and its 2-D output ``y2d``
(after the bias), walker-major ``[b * t, fan]``, keyed by the module path
joined with ``/`` (the JAX package's ``KfacState`` keys).  ``y2d`` stays in the
autograd graph, so the gradient with respect to it is the cotangent of the JAX
package's zero output tap.  Outside the context nothing is recorded.

The reduced-precision sweep passes its tower dtype explicitly: dense layers cast
their float32 parameters to the activation dtype on the fly, and LayerNorm keeps
its statistics in float32, as ``blocks.tower_dtype`` does in the JAX package.
"""

from __future__ import annotations

import contextlib
import math
from collections.abc import Iterator

import torch
from torch import nn

from deephall_tpu_torch.config import OrbitalType
from deephall_tpu_torch.geometry import chord_distances
from deephall_tpu_torch.utils import constant


# Cotangent that turns output sensitivities into exact-Fisher factors: the
# predictive distribution is a scalar Gaussian over Re log psi with variance
# 1/2, so the Fisher is E[g g^T] with g = sqrt(2) d(Re log psi)/d(y).
FISHER_COTANGENT = math.sqrt(2.0)


class Capture:
    """The recorded layers of one forward: ``inputs`` (detached) and ``outputs``
    (in the graph), both ``{path: [rows, fan]}``."""

    def __init__(self):
        self.inputs: dict[str, torch.Tensor] = {}
        self.outputs: dict[str, torch.Tensor] = {}


@contextlib.contextmanager
def kfac_capture(model: nn.Module) -> Iterator[Capture]:
    """Record the inputs and outputs of ``model``'s dense and LayerNorm layers."""
    capture = Capture()
    layers = [(name.replace(".", "/"), module) for name, module in model.named_modules()
              if isinstance(module, (Dense, DenseGeneral, LayerNorm))]
    for path, module in layers:
        module.kfac_record = (capture, path)
    try:
        yield capture
    finally:
        for _, module in layers:
            module.kfac_record = None


def _record(module: nn.Module, x2d: torch.Tensor, y2d: torch.Tensor) -> None:
    if module.kfac_record is not None:
        capture, path = module.kfac_record
        capture.inputs[path] = x2d.detach()
        capture.outputs[path] = y2d


def _param(*shape: int) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=torch.float32))


def _cast(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w if like.dtype == torch.float32 else w.to(like.dtype)


class DenseGeneral(nn.Module):
    """Linear map contracting ``axis`` of the input into ``features`` (appended last).

    Kernel ``(*in_shape, *features)``, bias ``features``.
    """

    def __init__(
        self,
        in_shape: tuple[int, ...],
        features: tuple[int, ...],
        axis: tuple[int, ...] = (-1,),
        use_bias: bool = True,
    ):
        super().__init__()
        self.in_shape = tuple(in_shape)
        self.features = tuple(features)
        self.axis = tuple(axis)
        self.kernel = _param(*self.in_shape, *self.features)
        self.bias = _param(*self.features) if use_bias else None
        self.kfac_record = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axes = sorted(a % x.ndim for a in self.axis)
        batch_axes = [a for a in range(x.ndim) if a not in axes]
        batch_shape = [x.shape[a] for a in batch_axes]
        fan_in = math.prod(self.in_shape)
        x2d = x.permute(*batch_axes, *axes).reshape(-1, fan_in)
        y2d = x2d @ _cast(self.kernel.reshape(fan_in, -1), x)
        if self.bias is not None:
            y2d = y2d + _cast(self.bias.reshape(1, -1), y2d)
        _record(self, x2d, y2d)
        return y2d.reshape(*batch_shape, *self.features)


class Dense(nn.Module):
    """Dense layer on the last axis: kernel ``(in, features)``, bias ``(features,)``."""

    def __init__(self, in_features: int, features: int, use_bias: bool = True):
        super().__init__()
        self.kernel = _param(in_features, features)
        self.bias = _param(features) if use_bias else None
        self.kfac_record = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x2d = x.reshape(-1, x.shape[-1])
        y2d = x2d @ _cast(self.kernel, x)
        if self.bias is not None:
            y2d = y2d + _cast(self.bias, y2d)
        _record(self, x2d, y2d)
        return y2d.reshape(*x.shape[:-1], y2d.shape[-1])


class LayerNorm(nn.Module):
    """Layer normalisation over the last axis; statistics in float32 at least."""

    def __init__(self, features: int, epsilon: float = 1e-5):
        super().__init__()
        self.epsilon = epsilon
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = _param(features)
        self.kfac_record = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        mean = xf.mean(dim=-1, keepdim=True)
        var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
        x_hat = ((xf - mean) * torch.rsqrt(var + self.epsilon)).to(x.dtype)
        x2d = x_hat.reshape(-1, x.shape[-1])
        y2d = x2d * _cast(self.scale, x) + _cast(self.bias, x)
        _record(self, x2d, y2d)
        return y2d.reshape(x.shape)


class MultiHeadAttention(nn.Module):
    """Self-attention over the electron axis (the JAX package's ``vpu`` math).

    Projections ``query``/``key``/``value`` with kernels ``[D, H, D//H]`` and an
    output projection ``out`` with kernel ``[H, D//H, D]``.
    """

    def __init__(self, features: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        head_dim = features // num_heads
        self.query = DenseGeneral((features,), (num_heads, head_dim))
        self.key = DenseGeneral((features,), (num_heads, head_dim))
        self.value = DenseGeneral((features,), (num_heads, head_dim))
        self.out = DenseGeneral((num_heads, head_dim), (features,), axis=(-2, -1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        head_dim = x.shape[-1] // self.num_heads
        query = self.query(x) / math.sqrt(head_dim)
        key = self.key(x)
        value = self.value(x)
        logits = torch.einsum("...thd,...shd->...tsh", query, key)
        weights = torch.softmax(logits, dim=-2)
        attn = torch.einsum("...tsh,...shd->...thd", weights, value)
        return self.out(attn)


class FeaturedOrbitals(nn.Module):
    """Complex orbital head: real + i*imag projections per spin sector."""

    def __init__(self, in_features: int, nspins: tuple[int, int], features: tuple[int, ...]):
        super().__init__()
        self.nspins = tuple(nspins)
        index = 0
        for n in self.nspins:
            if n:
                for _ in range(2):
                    self.add_module(
                        f"DenseGeneral_{index}", DenseGeneral((in_features,), features)
                    )
                    index += 1

    def forward(self, h_one: torch.Tensor) -> torch.Tensor:
        sectors = []
        index = 0
        for h_alpha in torch.split(h_one, list(self.nspins), dim=-2):
            if not h_alpha.shape[-2]:
                continue
            re = getattr(self, f"DenseGeneral_{index}")(h_alpha)
            im = getattr(self, f"DenseGeneral_{index + 1}")(h_alpha)
            index += 2
            sectors.append(torch.complex(re, im))
        return torch.cat(sectors, dim=-4)


def envelope_exponents(flux: int) -> tuple[list[int], list[int], torch.Tensor]:
    """Powers of ``u`` and ``v`` and the norms of the 2Q+1 LLL orbitals.

    Orbital ``m = -Q..Q`` is ``sqrt(C(2Q, Q-m)) u^(Q+m) v^(Q-m)``; both exponents
    are integers in ``0..2Q``.
    """
    n_orb = flux + 1
    alpha = list(range(n_orb))  # Q + m
    beta = [flux - a for a in alpha]  # Q - m
    norm = torch.tensor(
        [math.sqrt(math.comb(n_orb - 1, k)) for k in range(n_orb)], dtype=torch.float32
    )
    return alpha, beta, norm


def envelope(theta: torch.Tensor, phi: torch.Tensor, flux: int) -> torch.Tensor:
    """Monopole-harmonic envelope ``[..., N, 2Q+1]`` (complex).

    ``u^a v^b = cos(theta/2)^a sin(theta/2)^b e^{i (a-b) phi / 2}``, written in
    polar form so that the exponent 0 gives exactly 1.
    """
    alpha, beta, norm = envelope_exponents(flux)
    a = constant(tuple(alpha), theta.dtype, theta.device)
    b = constant(tuple(beta), theta.dtype, theta.device)
    c = torch.cos(theta / 2)[..., None]
    s = torch.sin(theta / 2)[..., None]
    mag = constant(tuple(norm.tolist()), norm.dtype, theta.device) * torch.pow(c, a) * torch.pow(s, b)
    return torch.polar(mag, 0.5 * (a - b) * phi[..., None])


class Orbitals(nn.Module):
    """Learned features contracted against the monopole-harmonics envelope.

    ``full``: one learned feature per LLL orbital (2Q+1).  ``sparse``: 8 learned
    features lifted to 2Q+1 by a learned complex linear map ``lll_weight``.
    """

    def __init__(
        self, in_features: int, type: OrbitalType, flux: int,
        nspins: tuple[int, int], ndets: int,
    ):
        super().__init__()
        self.type = OrbitalType(type)
        self.flux = flux
        n_orb = flux + 1
        nelec = sum(nspins)
        if self.type == OrbitalType.full:
            self.featured_orbitals = FeaturedOrbitals(
                in_features, nspins, (n_orb, nelec, ndets)
            )
        else:
            self.featured_orbitals = FeaturedOrbitals(in_features, nspins, (8, nelec, ndets))
            self.lll_weight = DenseGeneral((8,), (n_orb,), axis=(-3,))

    def forward(self, h_one, theta, phi):
        orbitals = self.featured_orbitals(h_one)  # [..., N, F, nelec, ndet]
        if self.type == OrbitalType.sparse:
            orbitals = torch.movedim(self.lll_weight(orbitals), -1, -3)
        env = envelope(theta, phi, self.flux)  # [..., N, 2Q+1]
        orbitals = torch.sum(orbitals * env[..., None, None], dim=-3)
        return torch.movedim(orbitals, -1, -3)  # [..., ndet, N, nelec]


def jastrow_pairs(nspins: tuple[int, int]):
    """Index pairs ``(i, j), i < j`` of the parallel and antiparallel channels."""
    n_up, n_down = nspins
    par = [(i, j) for i in range(n_up) for j in range(i + 1, n_up)]
    par += [(n_up + i, n_up + j) for i in range(n_down) for j in range(i + 1, n_down)]
    anti = [(i, n_up + j) for i in range(n_up) for j in range(n_down)]
    return par, anti


class Jastrow(nn.Module):
    """Two-parameter electron-electron cusp factor on chord distances.

    The ``ee_anti`` parameter exists whenever ``n_up > 0`` and ``ee_par`` whenever
    there is a parallel pair, as in the JAX package, so parameter trees match.
    """

    def __init__(self, nspins: tuple[int, int]):
        super().__init__()
        self.nspins = tuple(nspins)
        par, _ = jastrow_pairs(self.nspins)
        if par:
            self.ee_par = nn.Parameter(torch.ones(1))
        if self.nspins[0] > 0:
            self.ee_anti = nn.Parameter(torch.ones(1))

    def forward(self, electrons: torch.Tensor) -> torch.Tensor:
        r_ee = chord_distances(electrons)
        par, anti = jastrow_pairs(self.nspins)
        total = torch.zeros(r_ee.shape[:-2], dtype=r_ee.dtype, device=r_ee.device)
        for pairs, name, c in ((par, "ee_par", 0.25), (anti, "ee_anti", 0.5)):
            if pairs:
                alpha = getattr(self, name)
                # Index tensors made once on the device: a list would be
                # copied from the host at every call.
                i, j = (constant(v, torch.long, r_ee.device) for v in zip(*pairs))
                r = r_ee[..., i, j]
                total = total + torch.sum(-(c * alpha**2) / (alpha + r), dim=-1)
        return total
