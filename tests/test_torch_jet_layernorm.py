"""The jet LayerNorm of the port at the width its streamed and staged kernels take.

The plain version is what the CUDA kernels are held against on the card, so
these tests hold the plain version itself: against the JAX chain and the
Pallas kernel (interpret mode) at D = 256 in both production jet modes and at
the shapes beyond N = 6 that the staged kernel takes, and against a float64
evaluation for rows with a large mean.  They also cover the choice between
the three CUDA kernels, a pure function of the shapes and of the stages the
staged kernel's library finds room for, and the bytes of a stage.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu.networks import fwdlap as jax_nets_fwdlap
from deephall_tpu.ops import fwdlap as jax_fwdlap
from deephall_tpu.ops import jet_layernorm as jax_jet_layernorm
from deephall_tpu_torch.ops import fwdlap, jet_layernorm

torch.set_num_threads(2)

FEAT, BATCH, TOKENS = 256, 4, 6  # 24 rows: the Pallas row blocks need a multiple of 8
MODES = [(15, 3), (13, 1)]  # (C, E): with L^2, without
TOL = 2e-5  # of each output field's largest value


def random_jet(rng, c, e, mean=0.0):
    s = (BATCH, TOKENS, FEAT)
    return tuple(
        (rng.standard_normal(shape) + mean).astype(np.float32)
        for shape in (s, (c, *s), s, (e, *s))
    )


def random_params(rng):
    return {"scale": (rng.standard_normal(FEAT) * 0.3 + 1).astype(np.float32),
            "bias": (rng.standard_normal(FEAT) * 0.1).astype(np.float32)}


def to_torch(jet, dtype=torch.float32):
    return fwdlap.Jet(*(torch.from_numpy(v).to(dtype) for v in jet))


def field_errors(got, want):
    """Largest error of each field as a share of the field's largest value."""
    return {
        name: float(np.max(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)))
                    / np.max(np.abs(np.asarray(b, np.float64))))
        for name, a, b in zip(fwdlap.Jet._fields, got, want)
    }


# The production modes, then N = 10 lean and with L^2, N = 16 with L^2 and the
# largest jet the kernels take (C = 64, E = 4).
@pytest.mark.parametrize("c,e", MODES + [(21, 1), (23, 3), (35, 3), (64, 4)])
def test_plain_matches_jax_at_kernel_width(c, e):
    rng = np.random.default_rng(100 * c + e)
    x, r = random_jet(rng, c, e), random_jet(rng, c, e)
    p = random_params(rng)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jx, jr = (jax_fwdlap.Jet(*(jnp.asarray(v) for v in jet)) for jet in (x, r))
    chain = jax.jit(jax_nets_fwdlap._layernorm)(jp, jx, residual=jr)
    pallas = jax_jet_layernorm.layernorm_jet(jp, jx, residual=jr, interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = jet_layernorm.layernorm_jet(tp, to_torch(x), residual=to_torch(r))
    got = [v.numpy() for v in got]
    for want in (chain, pallas):
        errors = field_errors(got, want)
        assert max(errors.values()) <= TOL, errors


@pytest.mark.parametrize("c,e", MODES)
def test_plain_keeps_centred_moments(c, e):
    """Rows with a mean of 100 and a spread of 1.

    In float32, 100 + z carries an input rounding of 4e-6, and the centred
    planes inherit it: the outputs of the float32 chain stay within 1e-4 of the
    float64 evaluation of the same float32 inputs (measured: under 2e-5).  The
    one-pass variance E[x^2] - E[x]^2 would subtract two numbers near 1e4 and
    be off by about 1e-3.
    """
    rng = np.random.default_rng(7 * c + e)
    x, r = random_jet(rng, c, e, mean=100.0), random_jet(rng, c, e, mean=0.0)
    p = random_params(rng)
    got = jet_layernorm.layernorm_jet_plain(
        {k: torch.from_numpy(v) for k, v in p.items()}, to_torch(x), residual=to_torch(r)
    )
    want = jet_layernorm.layernorm_jet_plain(
        {k: torch.from_numpy(v).double() for k, v in p.items()},
        to_torch(x, torch.float64), residual=to_torch(r, torch.float64),
    )
    errors = field_errors([v.numpy() for v in got], [v.numpy() for v in want])
    assert max(errors.values()) <= 1e-4, errors
    # The one-pass form on the same rows, for the primal alone, misses that by far.
    t = torch.from_numpy(x[0]) + torch.from_numpy(r[0])
    one_pass_var = (t * t).mean(-1) - t.mean(-1) ** 2
    var = (t.double() - t.double().mean(-1, keepdim=True)).square().mean(-1)
    assert ((one_pass_var - var).abs() / var).max().item() > 1e-4


@pytest.mark.parametrize("feat,c,e,residual,rows,aligned,taken", [
    (256, 15, 3, True, 20160, True, True),
    (256, 13, 1, True, 20160, True, True),
    (256, 15, 3, True, 222, True, True),  # no multiple of a block's rows
    (256, 13, 1, True, 222, True, True),
    (256, 13, 1, True, 1, True, True),
    (64, 15, 3, True, 222, True, False),
    (512, 13, 1, True, 222, True, False),
    (256, 17, 1, True, 222, True, False),
    (256, 5, 2, True, 222, True, False),
    (256, 15, 1, True, 222, True, False),  # C of one mode with E of the other
    (256, 15, 3, False, 20160, True, False),  # no residual
    (256, 15, 3, True, 20160, False, False),  # a pointer off the 16-byte grid
    (256, 15, 3, True, 0, True, False),
])
def test_takes_streamed(feat, c, e, residual, rows, aligned, taken):
    assert jet_layernorm.takes_streamed(feat, c, e, residual, rows, aligned) is taken


# Stage bytes with a residual (two jets of P = C + E + 2 planes of D floats):
# N = 10, 12 and 16 with L^2 and C = 64, E = 4 at D = 256; without a residual;
# D = 512 and 1024.  The stages that fit on the card are the library's answer
# (test_torch_kernels_cuda.py::test_staged_stages_on_the_card).
@pytest.mark.parametrize("feat,c,e,residual,nbytes", [
    (256, 23, 3, True, 57_344),
    (256, 27, 3, True, 65_536),
    (256, 35, 3, True, 81_920),
    (256, 64, 4, True, 143_360),
    (256, 21, 1, True, 49_152),
    (256, 19, 3, True, 49_152),
    (256, 15, 3, True, 40_960),
    (256, 23, 3, False, 28_672),
    (256, 64, 4, False, 71_680),
    (512, 35, 3, True, 163_840),
    (1024, 64, 4, True, 573_440),
    (1024, 64, 4, False, 286_720),
])
def test_stage_bytes(feat, c, e, residual, nbytes):
    assert jet_layernorm.stage_bytes(feat, c, e, residual) == nbytes


@pytest.mark.parametrize("rows,aligned,stages,taken", [
    (33600, True, 4, True),  # N = 10 with L^2
    (33600, True, 2, True),  # N = 12 with L^2
    (222, True, 2, True),  # N = 16, no multiple of the grid
    (1, True, 1, True),  # C = 64, E = 4: one stage
    (20160, True, 8, True),
    (37, True, 6, True),
    (0x7FFFFFFF, True, 2, True),  # the most rows a launch takes
    (222, True, 0, False),
    (1, False, 1, False),
    (222, False, 0, False),
    (0, False, 8, False),
    (18, True, 0, False),  # D past the kernel's 512, or a row past one stage
    (33600, False, 4, False),  # a field off the 16-byte grid
    (0, True, 4, False),
])
def test_takes_staged(rows, aligned, stages, taken):
    assert jet_layernorm.takes_staged(rows, aligned, stages) is taken


@pytest.mark.parametrize("feat,c,e,residual,aligned,stages,kernel", [
    (256, 15, 3, True, True, 4, "streamed"),
    (256, 13, 1, True, True, 4, "streamed"),
    (256, 15, 3, False, True, 8, "staged"),
    (256, 23, 3, True, True, 4, "staged"),
    (256, 64, 4, True, True, 1, "staged"),
    (256, 15, 3, True, False, 4, "generic"),
    (256, 23, 3, False, False, 8, "generic"),
    (1024, 64, 4, True, True, 0, "generic"),
])
def test_route(feat, c, e, residual, aligned, stages, kernel):
    assert jet_layernorm.route(feat, c, e, residual, 222, aligned, stages) == kernel


def test_cpu_jet_counts_no_launch():
    rng = np.random.default_rng(3)
    c, e = MODES[0]
    p = {k: torch.from_numpy(v) for k, v in random_params(rng).items()}
    x, r = to_torch(random_jet(rng, c, e)), to_torch(random_jet(rng, c, e))
    fn = jet_layernorm.layernorm_jet
    before = fn.launches, fn.launches_streamed, fn.launches_staged
    out = fn(p, x, residual=r)
    generic = jet_layernorm.layernorm_jet_generic(p, x, residual=r)
    assert (fn.launches, fn.launches_streamed, fn.launches_staged) == before
    assert out.j.shape == x.j.shape and torch.isfinite(out.l).all()
    assert all(torch.equal(a, b) for a, b in zip(out, generic))
