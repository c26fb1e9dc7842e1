"""The port's jet rules and plain jet kernels against the JAX package.

The plain jet LayerNorm and jet attention are held against both the JAX
primitive chains (``networks/fwdlap._layernorm`` and ``_attention`` on its
``vpu`` path) and the Pallas kernels in interpret mode, as
``tests/test_jet_layernorm.py`` and ``tests/test_jet_attention.py`` run them.
Tolerance 2e-5 of each field's largest value, as those tests hold the kernels.
"""

from __future__ import annotations

import math

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu.geometry import chord_distances, spinors
from deephall_tpu.networks import fwdlap as jax_nets_fwdlap
from deephall_tpu.ops import fwdlap as jax_fwdlap
from deephall_tpu.ops import jet_attention as jax_jet_attention
from deephall_tpu.ops import jet_layernorm as jax_jet_layernorm
from deephall_tpu_torch.networks import fwdlap as nets_fwdlap
from deephall_tpu_torch.ops import fwdlap, jet_attention, jet_layernorm

torch.set_num_threads(2)

# (C, E, T): lean, L^2, N=8 lean, N=10 with L^2 (the extras' cross terms at T != 6)
SHAPES = [(13, 1, 6), (15, 3, 6), (17, 1, 8), (23, 3, 10)]
FEAT, HEADS, BATCH = 32, 4, 8


def random_jet(rng, batch, tokens, feat, c, e, dtype=np.float32):
    return tuple(
        rng.standard_normal(shape).astype(dtype)
        for shape in ((batch, tokens, feat), (c, batch, tokens, feat),
                      (batch, tokens, feat), (e, batch, tokens, feat))
    )


def to_jax(jet):
    return jax_fwdlap.Jet(*(jnp.asarray(v) for v in jet))


def to_torch(jet):
    return fwdlap.Jet(*(torch.from_numpy(np.asarray(v)) for v in jet))


def assert_jets_close(got, want, tol=2e-5, floor=1e-30):
    for name, a, b in zip(fwdlap.Jet._fields, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        scale = max(np.max(np.abs(b)), floor)
        np.testing.assert_allclose(a / scale, b / scale, rtol=tol, atol=tol, err_msg=name)


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("c,e,t", SHAPES)
def test_layernorm_plain_matches_jax(c, e, t, residual):
    rng = np.random.default_rng(c * 10 + e + residual)
    x = random_jet(rng, BATCH, t, FEAT, c, e)
    r = random_jet(rng, BATCH, t, FEAT, c, e) if residual else None
    p = {"scale": (rng.standard_normal(FEAT) * 0.3 + 1).astype(np.float32),
         "bias": (rng.standard_normal(FEAT) * 0.1).astype(np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    jr = to_jax(r) if residual else None
    chain = jax.jit(jax_nets_fwdlap._layernorm)(jp, to_jax(x), residual=jr)
    pallas = jax_jet_layernorm.layernorm_jet(jp, to_jax(x), residual=jr, interpret=True)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    got = jet_layernorm.layernorm_jet(tp, to_torch(x), residual=to_torch(r) if residual else None)
    assert_jets_close(got, chain)
    assert_jets_close(got, pallas)


def attention_params(rng, feat, heads):
    dh = feat // heads
    p = {name: {"kernel": rng.standard_normal((feat, heads, dh)) / np.sqrt(feat),
                "bias": rng.standard_normal((heads, dh)) * 0.1}
         for name in ("query", "key", "value")}
    p["out"] = {"kernel": rng.standard_normal((heads, dh, feat)) / np.sqrt(feat),
                "bias": rng.standard_normal(feat) * 0.1}
    return jax.tree.map(lambda v: np.asarray(v, np.float32), p)


@pytest.mark.parametrize("c,e,t", SHAPES)
def test_attention_plain_matches_jax(c, e, t, monkeypatch):
    rng = np.random.default_rng(100 + c)
    x = random_jet(rng, BATCH, t, FEAT, c, e)
    p = attention_params(rng, FEAT, HEADS)
    jp = jax.tree.map(jnp.asarray, p)
    monkeypatch.setattr(jax_nets_fwdlap, "JET_ATTENTION_IMPL", "vpu")
    chain = jax.jit(jax_nets_fwdlap._attention, static_argnums=1)(jp, HEADS, to_jax(x))
    pallas = jax_jet_attention.attention_jet(jp, HEADS, to_jax(x), interpret=True)
    got = jet_attention.attention_jet(jax.tree.map(torch.from_numpy, p), HEADS, to_torch(x))
    assert_jets_close(got, chain)
    assert_jets_close(got, pallas)


@pytest.mark.parametrize("c,e", [(13, 1), (15, 3)])
def test_attention_pieces_compose(c, e):
    # The packed pieces the CUDA path launches (projection GEMM, softmax-values
    # core, output GEMM), run through their plain versions on the CPU, give the
    # plain attention.
    rng = np.random.default_rng(7)
    batch, t = 4, 6
    x = to_torch(random_jet(rng, batch, t, FEAT, c, e))
    p = jax.tree.map(torch.from_numpy, attention_params(rng, FEAT, HEADS))
    scale = 1 / math.sqrt(FEAT // HEADS)
    rows = torch.cat([x.x[None], x.j, x.l[None], x.d]).reshape(-1, FEAT)
    w = torch.cat([p["query"]["kernel"].reshape(FEAT, FEAT) * scale,
                   p["key"]["kernel"].reshape(FEAT, FEAT), p["value"]["kernel"].reshape(FEAT, FEAT)], 1)
    b = torch.cat([p["query"]["bias"].reshape(-1) * scale, p["key"]["bias"].reshape(-1),
                   p["value"]["bias"].reshape(-1)])
    qkv = jet_attention.jet_gemm(rows, w, b, batch * t)
    attn = jet_attention.softmax_values(qkv, batch, t, HEADS, c, e)
    out = jet_attention.jet_gemm(
        attn, p["out"]["kernel"].reshape(FEAT, FEAT), p["out"]["bias"], batch * t
    ).reshape(c + e + 2, batch, t, FEAT)
    got = fwdlap.Jet(out[0], out[1:1 + c], out[1 + c], out[2 + c:])
    assert_jets_close(got, jet_attention.attention_jet_plain(p, HEADS, x))


@pytest.mark.parametrize("c,e", [(13, 1), (15, 3)])
def test_the_first_dense_writes_the_attention_planes(c, e):
    # The tower's first dense layer writes its jet into one buffer in the
    # attention's plane order: the same numbers as the dense layer, bit for
    # bit, and planes the attention reads in place (no stacked copy).
    rng = np.random.default_rng(11)
    x = to_torch(random_jet(rng, 4, 6, 7, c, e))
    p = {"kernel": torch.from_numpy(rng.standard_normal((7, FEAT)).astype(np.float32))}
    want = nets_fwdlap._dense(p, x, use_bias=False)
    got = nets_fwdlap._dense_planes(p, x)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    stacked = jet_attention.packed_planes(got)
    assert stacked is not None and stacked.data_ptr() == got.x.data_ptr()
    assert torch.equal(stacked, torch.cat([want.x[None], want.j, want.l[None], want.d]))


def test_cpu_tensors_take_the_plain_versions():
    rng = np.random.default_rng(0)
    x = to_torch(random_jet(rng, 4, 6, FEAT, 5, 1))
    p = {"scale": torch.ones(FEAT), "bias": torch.zeros(FEAT)}
    before = jet_layernorm.layernorm_jet.launches, jet_attention.attention_jet.launches
    ln = jet_layernorm.layernorm_jet(p, x)
    assert_jets_close(ln, jet_layernorm.layernorm_jet_plain(p, x), tol=0)
    ap = jax.tree.map(torch.from_numpy, attention_params(rng, FEAT, HEADS))
    jet_attention.attention_jet(ap, HEADS, x)
    assert (jet_layernorm.layernorm_jet.launches, jet_attention.attention_jet.launches) == before


def jax_curve_accelerations(jdata, compute_l2):
    """``(theta'', phi'')`` of the port's seed curves, from the JAX package's seeds.

    The port seeds unit great circles and rotations where the JAX package
    seeds straight lines in ``(theta, phi)`` with the same velocities.  Along
    the great circle through electron ``i`` tangent to ``e_phi`` the
    Christoffel term gives ``theta'' = cot theta_i`` (the one along
    ``e_theta`` is a coordinate line); a rotation's acceleration is its
    velocity field, the JAX seed as a function of the configuration,
    differentiated along itself (none for the rotation about z).
    """
    seeds = jax_fwdlap.electron_seeds(jdata, compute_l2)
    theta = jdata[..., 0]
    n = jdata.shape[-2]
    eye = jnp.eye(n, dtype=jdata.dtype).reshape((n,) + (1,) * (jdata.ndim - 2) + (n,))
    christoffel = jnp.stack([eye / jnp.tan(theta), jnp.zeros_like(eye * theta)], -1)
    lap = jnp.stack([jnp.zeros_like(christoffel), christoffel], 1).reshape(seeds[:2 * n].shape)
    flows = [jax.jvp(lambda d, k=k: jax_fwdlap.electron_seeds(d, compute_l2)[k], (jdata,),
                     (seeds[k],))[1] for k in range(2 * n, seeds.shape[0])]
    return jnp.concatenate([lap, jnp.stack(flows)])


def jax_curve_jet(f, jdata, compute_l2):
    """The jet of ``f`` along the port's seed curves from JAX's nested jvp:
    the coordinate second derivatives plus the first derivative along
    :func:`jax_curve_accelerations`."""
    extras = 3 if compute_l2 else 1
    seeds = jax_fwdlap.electron_seeds(jdata, compute_l2)
    coord = jax_fwdlap.jet_of_fn(f, jdata, seeds, extras)
    accel = jax_fwdlap.jet_of_fn(f, jdata, jax_curve_accelerations(jdata, compute_l2), extras).j
    k = seeds.shape[0] - extras
    return jax_fwdlap.Jet(coord.x, coord.j, coord.l + jnp.sum(accel[:k], 0), coord.d + accel[k:])


def jax_sphere_point(e):
    theta, phi = e[..., 0], e[..., 1]
    return jnp.stack([jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi),
                      jnp.cos(theta)], -1)


@pytest.mark.parametrize("compute_l2", [False, True])
def test_electron_seeds_match(compute_l2):
    # The point, and each seed curve's velocity and acceleration in Cartesian
    # coordinates: the point's first and second derivative along the JAX
    # package's seeds, plus its first derivative along the curves' coordinate
    # accelerations.
    rng = np.random.default_rng(1)
    data = np.stack([np.arccos(rng.uniform(-1, 1, (5, 6))), rng.uniform(-np.pi, np.pi, (5, 6))],
                    -1).astype(np.float32)
    jdata = jnp.asarray(data)
    seeds = jax_fwdlap.electron_seeds(jdata, compute_l2)

    def d1(v):
        return jax.jvp(jax_sphere_point, (jdata,), (v,))[1]

    def d2(v):
        return jax.jvp(lambda y: jax.jvp(jax_sphere_point, (y,), (v,))[1], (jdata,), (v,))[1]

    accelerations = jax_curve_accelerations(jdata, compute_l2)
    want_v = np.asarray(jax.vmap(d1)(seeds))
    want_a = np.asarray(jax.vmap(d2)(seeds) + jax.vmap(d1)(accelerations))
    got = fwdlap.electron_seeds(torch.from_numpy(data), compute_l2)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(jax_sphere_point(jdata)), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(got.v.numpy(), want_v, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got.a.numpy(), want_a, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c,e", [(12, 1), (12, 3)])
def test_logsumdet_jet_matches(c, e):
    # One complex LU + lu_solve against the JAX split-real elimination;
    # diagonally weighted matrices keep the solves well conditioned.
    rng = np.random.default_rng(c + e)
    b, ndet, n = 6, 2, 6

    def cplx(*shape):
        return (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)).astype(np.complex64)

    x = cplx(b, ndet, n, n) + 3 * np.eye(n, dtype=np.complex64)
    jet = (x, cplx(c, b, ndet, n, n), cplx(b, ndet, n, n), cplx(e, b, ndet, n, n))
    want = jax.jit(jax_fwdlap.logsumdet_jet)(to_jax(jet))
    got = fwdlap.logsumdet_jet(to_torch(jet))
    assert_jets_close(got, want, tol=1e-5)


def jax_input_jets(nspins, flux, params):
    """The JAX package's closed-over input functions (networks/fwdlap.py)."""
    spins = jnp.array([1] * nspins[0] + [-1] * nspins[1])
    q = flux / 2
    n_orb = flux + 1
    norm = jnp.asarray(np.sqrt([math.comb(n_orb - 1, k) for k in range(n_orb)]), jnp.float32)
    m = jnp.arange(-q, q + 1)

    def features(e):
        theta, phi = e[..., 0], e[..., 1]
        return jnp.stack([jnp.cos(theta), jnp.sin(theta) * jnp.cos(phi),
                          jnp.sin(theta) * jnp.sin(phi), jnp.broadcast_to(spins, theta.shape)], -1)

    def envelope(e):
        u, v = spinors(e[..., 0], e[..., 1])
        return norm * u[..., None] ** (q + m) * v[..., None] ** (q - m)

    def jastrow(e):
        r = chord_distances(e)
        n_up, n_down = nspins
        iu, idn = jnp.triu_indices(n_up, k=1), jnp.triu_indices(n_down, k=1)
        par = jnp.concatenate([r[..., :n_up, :n_up][..., iu[0], iu[1]],
                               r[..., n_up:, n_up:][..., idn[0], idn[1]]], -1)
        a_par, a_anti = params["ee_par"], params["ee_anti"]
        total = jnp.sum(-(0.25 * a_par**2) / (a_par + par), -1)
        return total + jnp.sum(-(0.5 * a_anti**2) / (a_anti + r[..., :n_up, n_up:]), (-2, -1))

    return features, envelope, jastrow


@pytest.mark.parametrize("compute_l2", [False, True])
def test_closed_form_input_jets_match_nested_jvp(compute_l2):
    # Closed-form derivatives along the port's seed curves against JAX's nested
    # jvp of the same functions converted to those curves (jax_curve_jet), the
    # envelope times the gauge factor e^{-i s Q phi} of its nearer pole:
    # float32 evaluation in another order, 2e-5 of each field's largest value,
    # with the functions' own scale (1) as the floor: the Jastrow is invariant
    # under rotations, so its exact d is 0 and JAX's is rounding.
    nspins, flux = (3, 2), 7
    rng = np.random.default_rng(5)
    data = np.stack([np.arccos(rng.uniform(-0.95, 0.95, (4, 5))),
                     rng.uniform(-np.pi, np.pi, (4, 5))], -1).astype(np.float32)
    params = {"ee_par": np.float32([0.8]), "ee_anti": np.float32([1.3])}
    extras = 3 if compute_l2 else 1
    jdata = jnp.asarray(data)
    tdata = torch.from_numpy(data)
    tseeds = fwdlap.electron_seeds(tdata, compute_l2)
    features, envelope, jastrow = jax_input_jets(nspins, flux, jax.tree.map(jnp.asarray, params))
    s = jnp.where(jnp.cos(jdata[..., :1]) >= 0, 1.0, -1.0)

    def gauged_envelope(e):
        return envelope(e) * jnp.exp(-0.5j * flux * s * e[..., 1:])

    tfns = (nets_fwdlap.input_feature_fn(nspins), nets_fwdlap.envelope_fn(flux),
            nets_fwdlap.jastrow_fn(nspins, jax.tree.map(torch.from_numpy, params)))
    for jf, tf in zip((features, gauged_envelope, jastrow), tfns):
        want = jax.jit(lambda d, f=jf: jax_curve_jet(f, d, compute_l2))(jdata)
        got = fwdlap.jet_of_fn(tf, tdata, tseeds, extras)
        assert_jets_close(got, want, floor=1.0)
