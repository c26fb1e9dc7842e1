"""Derivatives of the port's ``slogdet`` against the JAX package's, to second order.

The full-Hessian local energy differentiates ``log det`` twice, under
``torch.func`` (``vmap`` of ``jacfwd`` over ``jacrev``).  On
``A(x) = A0 + x B + x^2 B^T`` at x = 0.3 (n = 4, numpy-seeded), the JAX
package's custom-JVP ``slogdet`` in float64 / complex128 is the reference:
first derivatives to 1e-12 and second derivatives to 1e-8, relative.  The
first-order rule the port used before (``c A^-H`` from the forward's LU, kept
here as :class:`ParentSlogdet`) must give the same parameter gradient to 1e-12.
"""

from __future__ import annotations

import copy
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu.ops import slogdet as jax_slogdet
from deephall_tpu_torch import config
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import slogdet as sd
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts/prod_r4"
X = 0.3
FIRST_RTOL, SECOND_RTOL = 1e-12, 1e-8


def matrices(kind: str, batch: tuple = (), seed: int = 0):
    """``(A0, B)``, drawn in that order from ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)

    def draw():
        m = rng.standard_normal((*batch, 4, 4))
        return m + 1j * rng.standard_normal((*batch, 4, 4)) if kind == "complex" else m

    a0 = draw()
    return a0, draw()


def torch_logabs(a0, b):
    a0, b = torch.as_tensor(a0), torch.as_tensor(b)
    return lambda x: sd.slogdet(a0 + x * b + x**2 * b.mT)[1]


@functools.cache
def jax_derivatives(kind: str, batch: tuple = (), seed: int = 0):
    """(f', f'') at X of each matrix pair through the JAX package's ``slogdet``,
    in float64; f'' by ``jacfwd(jacrev)``, checked against ``grad(grad)``."""
    a0, b = matrices(kind, batch, seed)
    with jax.enable_x64(True):

        def derivatives(a0, b):
            def f(x):
                return jax_slogdet.slogdet(a0 + x * b + x**2 * b.T)[1]

            return jax.grad(f)(X), jax.jacfwd(jax.jacrev(f))(X), jax.grad(jax.grad(f))(X)

        fn = derivatives
        for _ in batch:
            fn = jax.vmap(fn)
        first, second, again = (np.asarray(v) for v in jax.jit(fn)(jnp.asarray(a0), jnp.asarray(b)))
    np.testing.assert_allclose(again, second, rtol=1e-12)
    return first, second


KINDS = ["complex", "real"]


@pytest.mark.parametrize("kind", KINDS)
def test_first_derivative(kind):
    a0, b = matrices(kind)
    first, _ = jax_derivatives(kind)
    x = torch.tensor(X, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(torch_logabs(a0, b)(x), x)
    np.testing.assert_allclose(got.item(), first, rtol=FIRST_RTOL)
    if kind == "complex":
        assert abs(first - 2.628250) < 1e-6


@pytest.mark.parametrize("kind", KINDS)
def test_second_derivative_by_double_backward(kind):
    a0, b = matrices(kind)
    _, second = jax_derivatives(kind)
    x = torch.tensor(X, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(torch_logabs(a0, b)(x), x, create_graph=True)
    (h,) = torch.autograd.grad(g, x)
    np.testing.assert_allclose(h.item(), second, rtol=SECOND_RTOL)
    if kind == "complex":
        assert abs(second - 334.1084) < 1e-4


@pytest.mark.parametrize("no_grad", [False, True])
@pytest.mark.parametrize("kind", KINDS)
def test_second_derivative_by_jacfwd_of_jacrev(kind, no_grad):
    # The loss evaluates the full-Hessian local energy under torch.no_grad,
    # which torch.func overrides: the result must not depend on it.
    a0, b = matrices(kind)
    _, second = jax_derivatives(kind)
    f = torch_logabs(a0, b)
    with torch.set_grad_enabled(not no_grad):
        h = torch.func.jacfwd(torch.func.jacrev(f))(torch.tensor(X, dtype=torch.float64))
    np.testing.assert_allclose(h.item(), second, rtol=SECOND_RTOL)


@pytest.mark.parametrize("kind", KINDS)
def test_vmap_over_a_batch(kind):
    a0, b = matrices(kind, batch=(5,), seed=1)
    want = jax_derivatives(kind, (5,), 1)

    def derivatives(a0_i, b_i):
        def f(x):
            return sd.slogdet(a0_i + x * b_i + x**2 * b_i.mT)[1]

        return torch.func.jacrev(f)(x0), torch.func.jacfwd(torch.func.jacrev(f))(x0)

    x0 = torch.tensor(X, dtype=torch.float64)
    first, second = torch.func.vmap(derivatives)(torch.as_tensor(a0), torch.as_tensor(b))
    np.testing.assert_allclose(first.numpy(), want[0], rtol=FIRST_RTOL)
    np.testing.assert_allclose(second.numpy(), want[1], rtol=SECOND_RTOL)


class ParentSlogdet(torch.autograd.Function):
    """The first-order rule the port used before: ``(sign, log|det a|)`` with the
    gradient ``c A^-H`` from the forward's LU, ``c = g_logabs + i Im(g_sign
    conj(sign))`` for complex ``a`` and ``g_logabs`` for real ``a``."""

    @staticmethod
    def forward(ctx, a):
        lu, pivots, _ = torch.linalg.lu_factor_ex(a)
        sign, logabs = sd._slogdet_from_lu(lu, pivots)
        ctx.save_for_backward(lu, pivots, sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, g_sign, g_logabs):
        lu, pivots, sign = ctx.saved_tensors
        eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device).expand(lu.shape)
        inv_h = torch.linalg.lu_solve(lu, pivots, eye, adjoint=True)
        c = g_logabs
        if lu.is_complex():
            c = torch.complex(g_logabs, (g_sign * sign.conj()).imag)
        return c[..., None, None] * inv_h


def parent_slogdet(a):
    return ParentSlogdet.apply(a)


def assert_relative(got: torch.Tensor, want: torch.Tensor, rtol: float) -> None:
    err = (got - want).abs().max().item()
    assert err <= rtol * want.abs().max().item(), (err, want.abs().max().item())


@pytest.mark.parametrize("kind", KINDS)
def test_matrix_gradient_matches_parent_rule(kind):
    """The gradient of a loss that reads both the sign and the log-magnitude."""
    a0, b = matrices(kind, batch=(3,))
    a = torch.as_tensor(a0 + X * b + X**2 * np.swapaxes(b, -1, -2))
    w_sign = torch.as_tensor(np.random.default_rng(2).standard_normal(3) * (1 + 1j if kind == "complex" else 1))
    grads = []
    for fn in (sd.slogdet, parent_slogdet):
        x = a.clone().requires_grad_(True)
        sign, logabs = fn(x)
        loss = (logabs * torch.arange(1.0, 4.0, dtype=torch.float64)).sum() + (w_sign * sign).real.sum()
        grads.append(torch.autograd.grad(loss, x)[0])
    assert_relative(grads[0], grads[1], FIRST_RTOL)


def test_psiformer_parameter_gradient_matches_parent_rule(monkeypatch):
    """``prod_r4``'s first 16 walkers through a float64 copy of the Psiformer:
    the parameter gradient of ``sum(w_re Re log psi + w_im Im log psi)``."""
    raw = yaml.safe_load((ARTIFACT / "config.yml").read_text())
    cfg = config.Config.from_dict(raw)
    with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        params, data = f["params"].tolist(), np.asarray(f["data"][:16], dtype=np.float64)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    model = copy.deepcopy(model).double()
    rng = np.random.default_rng(3)
    w = torch.as_tensor(rng.standard_normal(16) + 1j * rng.standard_normal(16))
    x = torch.from_numpy(data)

    def gradient():
        logpsi = model(x)
        out = (logpsi.real * w.real + logpsi.imag * w.imag).sum()
        return torch.autograd.grad(out, list(model.parameters()), allow_unused=True)

    got = gradient()
    monkeypatch.setattr(sd, "slogdet", parent_slogdet)
    want = gradient()
    assert sum(p is not None for p in want) > 30
    assert [g is None for g in got] == [p is None for p in want]
    # One vector over every leaf: some leaves' gradients cancel to rounding.
    assert_relative(torch.cat([g.flatten() for g in got if g is not None]),
                    torch.cat([p.flatten() for p in want if p is not None]), FIRST_RTOL)
