"""The port's measurement tools under ``scripts/``, on the CPU at small sizes.

* ``torch_flops_count.py``: the counter's rules against their closed forms
  (a real, a complex and a real-by-complex product, an elementwise operation,
  a reduction, the LAPACK solves, inverse and determinants), a whole
  Psiformer forward against the closed form of its products and against
  XLA's cost analysis of the JAX forward with the same parameters, the
  products of one jet attention against the kernel table's, the gradient and
  the jet local energy against XLA's cost analysis, an operation with no rule
  failing the count, the count affine in the walkers and the same per
  iteration at any block size.
* ``torch_production_block.py``: one block gives the energies of
  ``deephall_tpu_torch.train.train`` with the same configuration and seed.
* ``torch_profile_step.py``, ``torch_capture_trace.py``,
  ``torch_bench_jet_attention.py``, ``torch_bench_sublane_layout.py``: each
  runs at a tiny size with ``--device cpu`` and refuses to run without a card
  when none is asked for.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "scripts"))

import torch_bench_jet_attention  # noqa: E402
import torch_bench_sublane_layout  # noqa: E402
import torch_capture_trace  # noqa: E402
import torch_flops_count as fc  # noqa: E402
import torch_production_block  # noqa: E402
import torch_profile_step  # noqa: E402
import torch_trace_summary  # noqa: E402

from deephall_tpu import config as jax_config  # noqa: E402
from deephall_tpu.networks import make_network as jax_make_network  # noqa: E402
from deephall_tpu_torch import config, train  # noqa: E402
from deephall_tpu_torch.networks import make_network  # noqa: E402
from deephall_tpu_torch.weights import load_flax  # noqa: E402

torch.set_num_threads(2)
# A small network: N=3, 2Q=4, one layer of two heads of 8.
TINY = dict(nelec=3, flux=4, num_layers=1, num_heads=2, heads_dim=8)


def counted(fn):
    return fc.counted(fn)[0]


def run_main(main, argv) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return out.getvalue()


# --- the counter's rules -------------------------------------------------------------


def test_real_product():
    m, k, n = 5, 7, 3
    a, b = torch.randn(m, k), torch.randn(k, n)
    count = counted(lambda: a @ b)
    assert dict(count.flops) == {"float32 products": 2 * m * n * k}
    assert count.bytes == 4 * (m * k + k * n + m * n)


def test_complex_products():
    m, k, n = 4, 6, 5
    a, b = torch.randn(m, k, dtype=torch.complex64), torch.randn(k, n, dtype=torch.complex64)
    assert dict(counted(lambda: a @ b).flops) == {"complex": 8 * m * n * k}
    # A real operand cast to complex: two real products, and the cast.
    r = torch.randn(m, k)
    assert dict(counted(lambda: r.to(torch.complex64) @ b).flops) == {
        "float32 products": 4 * m * n * k, "other float32": m * k}


def test_elementwise_and_reduction():
    x, y = torch.randn(6, 9), torch.randn(6, 9)
    assert dict(counted(lambda: x + y).flops) == {"other float32": 54}
    assert dict(counted(lambda: x.sum(dim=-1)).flops) == {"other float32": 54}
    count = counted(lambda: torch.exp(x))
    assert count.transcendentals == 54 and sum(count.flops.values()) == 0
    z = torch.randn(6, 9, dtype=torch.complex64)
    assert dict(counted(lambda: z * z).flops) == {"complex": 6 * 54}


@pytest.mark.parametrize("n", [3, 6, 16])
def test_lu_factor(n):
    # LAPACK Working Note 41, xGETRF with m = n: n^3/3 + 2n/3 multiplications
    # and n^3/3 - n^2/2 + n/6 additions; complex ones are 6 and 2 real operations.
    batch = 5
    mults = n**3 / 3 + 2 * n / 3
    adds = n**3 / 3 - n**2 / 2 + n / 6
    real = torch.randn(batch, n, n)
    count = counted(lambda: torch.linalg.lu_factor_ex(real))
    assert dict(count.flops) == {"other float32": round(batch * (mults + adds))}
    cplx = torch.randn(batch, n, n, dtype=torch.complex64)
    count = counted(lambda: torch.linalg.lu_factor_ex(cplx))
    assert dict(count.flops) == {"complex": round(batch * (6 * mults + 2 * adds))}


def lawn41(n: int, routine: str, nrhs: int = 1) -> tuple[float, float]:
    """(multiplications, additions) of LAPACK Working Note 41, square ``n``."""
    if routine == "getrf":
        return n**3 / 3 + 2 * n / 3, n**3 / 3 - n**2 / 2 + n / 6
    if routine == "getrs":
        return nrhs * n**2, nrhs * (n**2 - n)
    return 2 * n**3 / 3 + n**2 / 2 + 5 * n / 6, 2 * n**3 / 3 - 3 * n**2 / 2 + 5 * n / 6  # getri


@pytest.mark.parametrize("op,n,nrhs", [
    ("solve", 8, 8), ("solve", 12, 5), ("inverse", 6, 0), ("lu_solve", 9, 4), ("slogdet", 6, 0),
])
def test_lapack_rules(op, n, nrhs):
    # The solves of KFAC (float32) and the determinants (complex64), each the
    # sum of LAWN 41's routines; a complex multiply is 6 real operations and
    # a complex add 2.  slogdet adds a phase product (complex multiply) and a
    # log per diagonal element.
    batch, dtype = 3, torch.complex64 if op == "slogdet" else torch.float32
    a = torch.randn(batch, n, n, dtype=dtype) + 4 * torch.eye(n)
    b = torch.randn(batch, n, nrhs)
    fns = {
        "solve": (lambda: torch.linalg.solve_ex(a, b), ["getrf", "getrs"]),
        "inverse": (lambda: torch.linalg.inv_ex(a), ["getrf", "getri"]),
        "slogdet": (lambda: torch.linalg.slogdet(a), ["getrf"]),
    }
    if op == "lu_solve":
        lu, pivots, _ = torch.linalg.lu_factor_ex(a)
        fns[op] = (lambda: torch.linalg.lu_solve(lu, pivots, b), ["getrs"])
    fn, routines = fns[op]
    mults, adds = (sum(v) for v in zip(*(lawn41(n, r, nrhs) for r in routines)))
    count = counted(fn)
    if op == "slogdet":
        assert dict(count.flops) == {"complex": round(batch * (6 * mults + 2 * adds + 6 * n))}
        assert count.transcendentals == batch * n
    else:
        assert dict(count.flops) == {"other float32": round(batch * (mults + adds))}


def test_an_operation_without_a_rule_fails_the_count():
    x = torch.randn(16)
    with pytest.raises(fc.UncountedOp, match=r"aten\._fft"):
        counted(lambda: torch.fft.fft(x))


# --- a whole forward ---------------------------------------------------------------------


def forward_models(nelec, flux, layers, heads, heads_dim, compute_l2=False):
    raw = {"system": {"nspins": [nelec, 0], "flux": flux, "compute_l2": compute_l2},
           "network": {"psiformer": {"num_layers": layers, "num_heads": heads,
                                     "heads_dim": heads_dim}}}
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    cfg = config.Config.from_dict(raw)
    return jmodel, make_network(cfg.system, cfg.network)


def dense_products(batch, nelec, flux, layers, heads, heads_dim, ndet=1):
    """2 m n k of every product of the Psiformer forward: the input layer,
    per layer the q/k/v and output projections, the two dense layers and the
    logits and value contractions, then the real and imaginary orbital heads."""
    d, rows = heads * heads_dim, batch * nelec
    per_layer = 6 * 2 * rows * d * d + 2 * 2 * batch * heads * nelec * nelec * heads_dim
    orbitals = 2 * 2 * rows * d * (flux + 1) * nelec * ndet
    return 2 * rows * 4 * d + layers * per_layer + orbitals


@pytest.mark.parametrize("shape,tol", [
    # (batch, nelec, flux, layers, heads, heads_dim); measured gap 2.8% and 0.03%.
    ((16, 3, 4, 1, 2, 8), 0.05),
    ((32, 4, 9, 2, 4, 16), 0.005),
])
def test_forward_against_closed_form_and_xla(shape, tol):
    # The products agree exactly with their closed form.  XLA counts the same
    # products, so the totals differ only in the rest: the JAX forward takes
    # its complex determinant through a split-real elimination of elementwise
    # operations where the port's takes LAPACK's LU count, and the two write
    # the softmax, the LayerNorm and the envelope with other elementwise
    # operations.  That rest is a few percent of a small network's total and
    # shrinks with the widths.
    batch, nelec, flux, layers, heads, heads_dim = shape
    jmodel, model = forward_models(nelec, flux, layers, heads, heads_dim)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(7),
                                                          jnp.zeros((nelec, 2))))
    load_flax(model, params)
    rng = np.random.default_rng(0)
    data = np.stack([np.arccos(rng.uniform(-1, 1, (batch, nelec))),
                     rng.uniform(-np.pi, np.pi, (batch, nelec))], -1).astype(np.float32)
    cost = jax.jit(jmodel.apply).lower(params, jnp.asarray(data)).cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    x = torch.from_numpy(data)
    with torch.no_grad():
        model(x)  # the process's constants first
        count = counted(lambda: model(x))
    assert count.flops["float32 products"] == dense_products(*shape)
    assert count.flops["bf16 products"] == 0
    total = sum(count.flops.values())
    assert abs(total / cost["flops"] - 1) < tol, (total, cost["flops"])


@pytest.mark.parametrize("batch,tokens,features,heads,c,e", [
    (4, 6, 32, 2, 5, 1), (3, 6, 64, 4, 15, 3), (2, 5, 16, 4, 13, 1),
])
def test_attention_products_are_the_kernel_tables(batch, tokens, features, heads, c, e):
    # One attention_jet_plain call does exactly the products of the core and
    # the four projections that jet_attention.attention_work gives the kernel
    # table's bound (at B=3360, (C, E) = (15, 3): 158.5 GFLOP for q/k/v).
    from deephall_tpu_torch.ops import jet_attention as ja
    from deephall_tpu_torch.ops.fwdlap import Jet

    gen = torch.Generator().manual_seed(0)
    dh = features // heads
    p = {n: {"kernel": torch.randn(features, heads, dh, generator=gen),
             "bias": torch.randn(heads, dh, generator=gen)} for n in ("query", "key", "value")}
    p["out"] = {"kernel": torch.randn(heads, dh, features, generator=gen),
                "bias": torch.randn(features, generator=gen)}
    s = (batch, tokens, features)
    t = Jet(*(torch.randn(*lead, *s, generator=gen) for lead in ((), (c,), (), (e,))))
    with torch.no_grad():
        count = counted(lambda: ja.attention_jet_plain(p, heads, t))
    _, core, projections = ja.attention_work(batch, tokens, features, heads, c, e)
    assert count.flops["float32 products"] == core + projections
    assert set(count.flops) == {"float32 products", "other float32"}


def xla_flops(fn, *args) -> float:
    cost = jax.jit(fn).lower(*args).cost_analysis()
    return (cost[0] if isinstance(cost, list) else cost)["flops"]


@pytest.mark.parametrize("shape", [(32, 4, 9, 2, 4, 16), (32, 6, 15, 2, 4, 32)])
@pytest.mark.parametrize("part,tol", [
    # Measured gaps: 0.07% and 0.02% (gradient), 0.3% and 0.25% (jet, both modes).
    ("gradient", 0.002), ("local energy lean", 0.01), ("local energy l2", 0.01),
])
def test_gradient_and_local_energy_against_xla(part, tol, shape):
    # The two largest parts of an iteration after the sweep, against XLA's
    # count of the JAX function with the same parameters: the forward with the
    # backward pass of a real and an imaginary cotangent (the training step's
    # gradient), and the forward-Laplacian local energy.  XLA counts a complex
    # product as 2 m n k and a complex multiply as 1, where the port counts
    # real operations.  The JAX jet takes its orbital head as one complex
    # product of the real-cast planes, which the port counts as two real
    # products: that closed-form difference is taken off before the
    # comparison.  What is left is the elementwise rest (complex multiplies,
    # the jet's elementwise chains written with other operations).
    from deephall_tpu.loss import forward_laplacian_local_energy as jax_local_energy
    from deephall_tpu_torch.loss import batched_local_energy

    batch, nelec, flux, layers, heads, heads_dim = shape
    l2 = part.endswith("l2")
    jmodel, model = forward_models(nelec, flux, layers, heads, heads_dim, compute_l2=l2)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(7),
                                                          jnp.zeros((nelec, 2))))
    load_flax(model, params)
    rng = np.random.default_rng(0)
    data = np.stack([np.arccos(rng.uniform(-1, 1, (batch, nelec))),
                     rng.uniform(-np.pi, np.pi, (batch, nelec))], -1).astype(np.float32)
    x = torch.from_numpy(data)
    if part == "gradient":
        w = rng.normal(size=(2, batch)).astype(np.float32)

        def weighted(p, data, w):
            log_psi = jmodel.apply(p, data)
            return jnp.sum(log_psi.real * w[0] + log_psi.imag * w[1])

        want = xla_flops(jax.grad(weighted), params, jnp.asarray(data), jnp.asarray(w))
        wt, leaves = torch.from_numpy(w), list(model.parameters())

        def fn():
            log_psi = model(x)
            return torch.autograd.grad((log_psi.real * wt[0] + log_psi.imag * wt[1]).sum(),
                                       leaves, allow_unused=True)
        convention = 0
    else:
        raw = {"system": {"nspins": [nelec, 0], "flux": flux, "compute_l2": l2}}
        want = xla_flops(jax_local_energy(jmodel, jax_config.Config.from_dict(raw).system),
                         params, jnp.asarray(data))
        local_energy = batched_local_energy(model, config.Config.from_dict(raw).system)
        fn = torch.no_grad()(lambda: local_energy(x))
        c = 2 * nelec + (3 if l2 else 1)
        planes = c + (3 if l2 else 1) + 2
        convention = 2 * planes * batch * nelec * heads * heads_dim * (flux + 1) * nelec
    fn()  # the process's constants first
    count = counted(fn)
    got = sum(count.flops.values()) - convention
    assert abs(got / want - 1) < tol, (got, want)


# --- the iteration ---------------------------------------------------------------------


def test_count_is_affine_in_the_walkers_and_independent_of_the_block():
    batches = (4, 8, 12)
    runs = {b: fc.count_block(False, b, 1, **TINY) for b in (*batches, 20)}
    for part in runs[4]:
        carried = fc.carry(runs[4][part], runs[8][part], (4, 8), 20)
        direct = runs[20][part].affine()
        direct["other float32"] += fc.sort_flops(runs[20][part].sorts)
        assert carried == direct, part
    one = fc.per_iteration(False, 1, 20, batches, **TINY)
    assert one == fc.per_iteration(False, 2, 20, batches, **TINY)
    assert all(v > 0 for v in one["total"].values())
    parts = one["parts"]
    assert set(parts) == set(fc.PARTS)
    assert all(v >= 0 for row in parts.values() for v in row.values())
    assert parts["sweep"]["bf16 products"] > 0  # the bf16 sweep
    assert parts["local energy"]["float32 products"] > parts["sweep"]["float32 products"]


def test_script_prints_the_count(monkeypatch):
    count = fc.per_iteration
    monkeypatch.setattr(fc, "per_iteration",
                        lambda l2, block: count(l2, block, 20, (4, 8, 12), **TINY))
    lines = run_main(fc.main, ["--l2", "--block", "1"]).splitlines()
    assert any(line.startswith("local energy") for line in lines)
    summary = json.loads(lines[-1])
    assert summary["flops"] == sum(summary["by_class"].values()) > 0
    assert 0 < summary["operations_ms"] and 0 < summary["bytes_ms"]


def test_production_block_gives_the_training_runs_energies(tmp_path):
    cfg, block, state, _, pmoves, t = torch_production_block.build_production_block(
        True, 3, "cpu", batch=16, **TINY)
    *_, stats, _ = block(state, pmoves, t, 3)
    run_cfg = torch_production_block.production_config(True, 3, batch=16, **TINY)
    run_cfg.mcmc.burn_in = 0
    run_cfg.optim.iterations = 3
    run_cfg.log.initial_energy = False
    run_cfg.log.save_path = str(tmp_path / "run")
    history = train.train(run_cfg, device="cpu")
    want = np.array([row["energy"] for row in history])
    got = stats["energy"].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# --- the scripts that run the model ------------------------------------------------------


@pytest.mark.parametrize("fast", [False, True])
def test_profile_step_prints_every_part(fast):
    argv = ["--nelec", "3", "--flux", "4", "--batch", "8", "--device", "cpu"]
    text = run_main(torch_profile_step.main, argv + (["--fast"] if fast else []))
    labels = ["forward (batch 8)", "slogdet (batch x 1 dets)", "mcmc sweep (10 moves)",
              "local energy (jet, (C, E) = (7, 1))" if fast else "local energy (jet, (C, E) = (9, 3))",
              "loss + energy gradient", "full KFAC training step", "fused iteration (block of 10)"]
    if fast:
        labels.append("logsumdet_jet (det share)")
    for label in labels:
        assert f"\n{label}:" in text
    assert "it/s" in text


def test_capture_trace_writes_a_trace_that_the_summary_reads(tmp_path):
    path = torch_capture_trace.capture(tmp_path / "trace", False, 1, "cpu", batch=8, **TINY)
    assert path == tmp_path / "trace" / "trace.json"
    events = torch_trace_summary.load_events(path)
    assert any(e["name"].startswith("aten::") for e in events)
    # A CPU trace has no device events: its busy share is not measured.
    with pytest.raises(ValueError, match="no device events"):
        torch_trace_summary.summarise(events)


def test_attention_routes_agree(monkeypatch):
    # On the CPU both routes are the plain version, so their error is 0 by
    # construction; a kernel route off by 1e-4 of its output must show.
    from deephall_tpu_torch.ops import jet_attention as ja

    result = torch_bench_jet_attention.run(["kernel", "plain"], 4, torch.device("cpu"), 1)
    assert set(result) == {"lean kernel", "lean plain", "l2 kernel", "l2 plain"}
    assert all(row["ms"] > 0 and row["max_rel_err"] == 0 for row in result.values())
    plain = ja.attention_jet_plain
    monkeypatch.setattr(ja, "attention_jet", lambda p, h, t: type(t)(
        *(f * (1 + 1e-4) for f in plain(p, h, t))))
    result = torch_bench_jet_attention.run(["kernel", "plain"], 4, torch.device("cpu"), 1)
    for mode in ("lean", "l2"):
        assert result[f"{mode} plain"]["max_rel_err"] == 0
        assert 0.9e-4 < result[f"{mode} kernel"]["max_rel_err"] < 1.1e-4


def test_sublane_layouts_agree():
    result = torch_bench_sublane_layout.run((3, 5, 6, 32), torch.device("cpu"), 1)
    assert result["equal"] and result["max_abs_diff"] == 0
    assert result["batch-major"]["ms"] > 0 and result["token-major"]["ms"] > 0


@pytest.mark.parametrize("main", [
    torch_profile_step.main, torch_bench_jet_attention.main, torch_bench_sublane_layout.main,
    lambda argv: torch_capture_trace.main(["--out", "unused", *argv]),
])
def test_runs_on_the_card_by_default(main, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit):
        main([])
    assert "CUDA was requested" in err.getvalue()


def test_pole_probe_runs_on_the_card_by_default(monkeypatch):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_laughlin_pole_probe", REPO / "scripts" / "torch_laughlin_pole_probe.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        probe.main([])
    assert math.isfinite(float(run_main(probe.main, ["--device", "cpu", "--walkers", "16"])
                               .splitlines()[-1].split()[-1]))


def test_local_energy_timing_needs_the_card(monkeypatch):
    # It times the kernels: without a card it exits 1 and prints no result.
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_local_energy_timing", REPO / "scripts" / "torch_local_energy_timing.py")
    timing = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(timing)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert timing.main([]) == 1
    assert out.getvalue() == "" and "no CUDA card" in err.getvalue()
