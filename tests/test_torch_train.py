"""The port's training path against the JAX package: the slogdet gradient, the
energy gradients, Adam against optax, checkpoints with optimizer state both
ways, and the training CLI.

Small sizes: N = 3 (both spin sectors for the gradients), 2Q = 2 or 4, one
layer of 1-2 heads x 4, 8-64 walkers drawn from a NumPy seed; the JAX
parameters are carried across with ``load_flax``.  Tolerances are stated per
test; the measured errors are recorded in ``PERF.md``.
"""

from __future__ import annotations

import csv
import logging
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import optax
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import loss as jax_loss
from deephall_tpu import optimizers as jax_optimizers
from deephall_tpu.log import LogManager as JaxLogManager
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.ops import slogdet as jax_slogdet
from deephall_tpu.optimizers import kfac as jax_kfac
from deephall_tpu.types import CheckpointState as JaxCheckpointState
from deephall_tpu_torch import config, loss, optimizers, train
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.optimizers.adam import make_adam_training_step
from deephall_tpu_torch.ops import jet_attention
from deephall_tpu_torch.ops.slogdet import slogdet
from deephall_tpu_torch.types import AdamState, CheckpointState, KfacState
from deephall_tpu_torch.weights import flatten, init_params, load_flax, param_tree, params_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
RAW = {
    "system": {"nspins": [2, 1], "flux": 4},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 4}},
}
TINY = [
    "seed=42", "batch_size=64", "system.nspins=[3,0]", "system.flux=2",
    "system.interaction_strength=0", "network.psiformer.num_layers=1",
    "network.psiformer.num_heads=1", "network.psiformer.heads_dim=4",
    "log.initial_energy=false",
]
CPU = ["--device", "cpu"]


def random_walkers(seed, batch, nelec):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def random_params(seed, raw=RAW):
    """A flax parameter tree of NumPy arrays: the port's LeCun-normal init."""
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(seed))
    return params_to_flax(model)


def max_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def complex_batch(seed, batch, n, singular_value=None):
    """Random complex ``[batch, n, n]``; with ``singular_value`` the smallest
    singular value of each matrix is set to it (the others are about 1)."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)) + 1j * rng.standard_normal((batch, n, n))
    if singular_value is not None:
        u, _, vh = np.linalg.svd(a)
        s = np.linspace(2.0, 1.0, n)
        s[-1] = singular_value
        a = (u * s) @ vh  # scales the columns of u
    return a.astype(np.complex64)


@jax.jit
@jax.grad
def jax_slogdet_grad(a, c1, c2):
    sign, logabs = jax_slogdet.slogdet(a)
    return jnp.sum(c1 * logabs + (jnp.conj(c2) * sign).real)


@pytest.mark.parametrize("case", ["random", "nearly_singular"])
def test_slogdet_gradient_matches(case):
    # Gradient of sum(c1 log|det| + Re(conj(c2) sign)) over 32 complex 6x6
    # matrices, from the port (the LU's A^-H in float32), from the JAX
    # package's custom JVP (float32) and from torch.linalg.slogdet in float64.
    # Against float64: 1e-5 of the largest entry for random matrices, 1e-3
    # when the smallest singular value is 1e-3 (float32 solves lose about
    # cond x 6e-8).
    a = complex_batch(3, 32, 6, singular_value=1e-3 if case == "nearly_singular" else None)
    rng = np.random.default_rng(4)
    c1 = rng.standard_normal(32).astype(np.float32)
    c2 = (rng.standard_normal(32) + 1j * rng.standard_normal(32)).astype(np.complex64)

    def torch_grad(fn, dtype):
        x = torch.from_numpy(a).to(dtype).requires_grad_(True)
        sign, logabs = fn(x)
        k1, k2 = torch.from_numpy(c1).to(logabs.dtype), torch.from_numpy(c2).to(sign.dtype)
        (g,) = torch.autograd.grad((k1 * logabs + (k2.conj() * sign).real).sum(), x)
        return g.numpy()

    got = torch_grad(slogdet, torch.complex64)
    want = torch_grad(torch.linalg.slogdet, torch.complex128)
    # JAX returns the conjugate of the gradient that torch returns.
    jax_got = np.conj(np.asarray(jax_slogdet_grad(a, c1, c2)))
    tol = 1e-3 if case == "nearly_singular" else 1e-5
    assert max_rel(got, want) < tol
    assert max_rel(jax_got, want) < tol
    assert max_rel(got, jax_got) < tol


@pytest.fixture(scope="module")
def gradients():
    """The JAX package's ENERGY_GRAD and SR_F_VECTOR on the same inputs (one jit)."""
    jcfg = jax_config.Config.from_dict(RAW)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = random_params(3)
    data = random_walkers(7, 16, 3)
    modes = ("ENERGY_GRAD", "SR_F_VECTOR")
    fns = [jax_loss.make_loss_fn(jmodel.apply, jcfg.system, jax_loss.LossMode[m], model=jmodel)
           for m in modes]
    results = jax.jit(lambda p, d: [fn(p, d) for fn in fns])(params, jnp.asarray(data))
    out = {m: (jax.tree.map(np.asarray, stats), flatten(jax.tree.map(np.asarray, grads)))
           for m, (stats, grads) in zip(modes, results)}
    return params, data, out


@pytest.mark.parametrize("mode", ["ENERGY_GRAD", "SR_F_VECTOR"])
def test_energy_gradients_match(gradients, mode):
    # 1e-4 of each leaf's largest value (the weights w_i carry the local
    # energies' float32 differences, the backward pass its own summation
    # order); SR's imaginary part likewise.  The key bias's gradient is zero in
    # exact arithmetic (the softmax ignores a shift of its logits), so each
    # leaf's scale is at least 1e-4 of the whole gradient's largest value.
    params, data, out = gradients
    want_stats, want = out[mode]
    largest = max(np.abs(v).max() for v in want.values())
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    stats, grads = loss.make_loss_fn(model, cfg.system, loss.LossMode[mode])(torch.from_numpy(data))
    assert sorted(grads) == sorted(want) == sorted(n for n, _ in model.named_parameters())
    for name, g in grads.items():
        g = g.numpy()
        assert np.iscomplexobj(g) == (mode == "SR_F_VECTOR")
        for part in (np.real, np.imag) if mode == "SR_F_VECTOR" else (np.real,):
            scale = max(np.abs(part(want[name])).max(), 1e-4 * largest)
            assert np.abs(part(g) - part(want[name])).max() < 1e-4 * scale, (name, part.__name__)
    assert float(stats["energy"].real) == pytest.approx(float(want_stats["energy"].real), rel=1e-4)


@pytest.mark.parametrize("steps", [1, 3])
def test_adam_matches_optax(steps):
    # The same gradients (NumPy draws, of magnitudes 1e-3 to 10) through
    # optax.adam and the port's Adam from the same parameters: parameters and
    # moments to 1e-5 of each leaf's largest value (XLA and torch may round a
    # parameter's last bit apart), the count exactly.  A first step moves every
    # parameter by about the learning rate, 5e-3.
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    jcfg = jax_config.Config.from_dict(RAW)
    params = random_params(1)
    load_flax(model, params)
    rng = np.random.default_rng(steps)
    names = [n for n, _ in model.named_parameters()]
    grads = [{n: rng.standard_normal(p.shape).astype(np.float32) * 10.0 ** rng.integers(-3, 2)
              for n, p in model.named_parameters()} for _ in range(steps)]

    tx = optax.adam(learning_rate=jcfg.optim.adam.lr.schedule)
    jparams, jstate = params, tx.init(params)
    for g in grads:
        tree = {"params": {}}
        for n, v in g.items():
            node = tree["params"]
            *path, leaf = n.split(".")
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = v
        updates, jstate = tx.update(tree, jstate)
        jparams = optax.apply_updates(jparams, updates)

    feed = iter(grads)
    init, step = make_adam_training_step(
        cfg.optim.adam, lambda data: ({}, {n: torch.from_numpy(v) for n, v in next(feed).items()}), model
    )
    state = CheckpointState(None, None, init(model, None), 0.1)
    for _ in grads:
        state, _ = step(state)
    got, want, start = flatten(params_to_flax(model)), flatten(jparams), flatten(params)
    for n in names:
        assert max_rel(got[n], want[n]) < 1e-5, n
        assert not np.array_equal(got[n], start[n]), n
    adam = jstate[0]
    assert int(state.opt_state.count) == int(adam.count) == steps
    for ours, theirs in ((state.opt_state.mu, adam.mu), (state.opt_state.nu, adam.nu)):
        ours, theirs = flatten(ours), flatten(theirs)
        for n in names:
            assert max_rel(ours[n].numpy(), theirs[n]) < 1e-5, n


def test_optimizer_steps_rebuild_the_attention_weights():
    # The optimizers write the parameters in place, which moves the version
    # that prepare_weights reads: its split, scaled copy of the attention
    # weights is rebuilt from the new values instead of served stale.
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(4))

    def attention_weights():
        layer = param_tree(model)["PsiformerLayers_0"]["MultiHeadAttention_0"]
        return layer, jet_attention.prepare_weights(layer, 2)

    _, first = attention_weights()
    assert attention_weights()[1] is first
    grads = {n: torch.ones_like(p) for n, p in model.named_parameters()}
    init, step = make_adam_training_step(cfg.optim.adam, lambda data: ({}, grads), model)
    step(CheckpointState(None, None, init(model, None), 0.1))
    layer, again = attention_weights()
    assert again is not first
    wq = layer["query"]["kernel"].reshape(8, 8) / 2.0  # 1/sqrt(dh), dh = 4
    torch.testing.assert_close(again.wqkv.w[:, :8], wq, rtol=0, atol=0)
    assert not torch.equal(again.wqkv.w, first.wqkv.w)


def test_training_step_imports_no_jax():
    # The production state resumed under KFAC, one step on 4 stored walkers:
    # neither JAX nor the JAX package is imported on the way.
    script = textwrap.dedent(
        """
        import sys
        import yaml
        import torch
        torch.set_num_threads(2)
        from deephall_tpu_torch.config import Config
        from deephall_tpu_torch.log import LogManager
        from deephall_tpu_torch.networks import make_network
        from deephall_tpu_torch.optimizers import make_optimizer_step, state_to, validate_opt_state
        from deephall_tpu_torch.weights import load_flax

        cfg = Config.from_dict(yaml.safe_load(open("artifacts/prod_r4/config.yml")))
        _, state, _ = LogManager.restore_checkpoint("artifacts/prod_r4/ckpt_019999.npz")
        model = make_network(cfg.system, cfg.network)
        load_flax(model, state.params)
        opt_state = state_to(validate_opt_state(cfg, state.opt_state), "cpu")
        _, step = make_optimizer_step(cfg, model)
        state = state._replace(data=torch.as_tensor(state.data[:4]), opt_state=opt_state)
        state, stats = step(state)
        assert int(state.opt_state.step) == 20001 and torch.isfinite(stats["energy"].real)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "deephall_tpu"))
        print("IMPORTED", bad)
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
    assert "IMPORTED []" in out.stdout, out.stdout


def tiny_config(save_path, *dotlist):
    cfg = config.Config.from_dict(config.resolve_interpolations(config.merge_dicts(
        config.to_dict(config.Config()), config.dotlist_to_dict([*TINY, *dotlist]))))
    cfg.log.save_path = str(save_path)
    return cfg


def test_cli_tiny_kfac_run_reaches_lll_energy(tmp_path):
    # Three free electrons at 2Q=2: exact energy 1.5.  As the JAX package's
    # tests/test_train.py: KFAC drives the energy into the 1.4x-1.5x band.
    history = train.cli([*TINY, "mcmc.burn_in=50", "optim.iterations=100", "optim.optimizer=kfac",
                         f"log.save_path={tmp_path}", *CPU])
    assert len(history) == 100
    with open(tmp_path / "train_stats.csv") as f:
        energies = [row["energy"] for row in csv.DictReader(f)]
    assert any(e.startswith("1.5") for e in energies)
    assert any(e.startswith("1.4") for e in energies)
    _, state, _ = LogManager.restore_checkpoint(tmp_path / "ckpt_000099.npz")
    assert isinstance(state.opt_state, KfacState) and int(state.opt_state.step) == 100


def test_cli_adam_run_and_resume_under_kfac(tmp_path, capsys):
    # Adam trains finitely; resuming its checkpoint under KFAC drops the Adam
    # state with validate_opt_state's warning and starts KFAC from zero.
    history = train.cli([*TINY, "batch_size=16", "mcmc.burn_in=2", "optim.iterations=3",
                         "optim.optimizer=adam", f"log.save_path={tmp_path}", *CPU])
    assert len(history) == 3 and all(np.isfinite(row["energy"].real) for row in history)
    _, state, _ = LogManager.restore_checkpoint(tmp_path / "ckpt_000002.npz")
    assert isinstance(state.opt_state, AdamState) and int(state.opt_state.count) == 3
    train.cli([*TINY, "batch_size=16", "optim.iterations=4", "optim.optimizer=kfac",
               f"log.save_path={tmp_path}", *CPU])
    err = capsys.readouterr().err
    assert "Restored opt_state (AdamState) does not match optimizer kfac; reinitialising" in err
    assert "Burn in MCMC complete" not in err.split("Restored checkpoint")[-1]
    _, state, _ = LogManager.restore_checkpoint(tmp_path / "ckpt_000003.npz")
    assert isinstance(state.opt_state, KfacState) and int(state.opt_state.step) == 1


def test_resume_continues_from_checkpoint(tmp_path, capsys):
    cfg = tiny_config(tmp_path, "batch_size=16", "mcmc.burn_in=5", "optim.iterations=1")
    train.train(cfg, device="cpu")
    assert (tmp_path / "ckpt_000000.npz").exists()
    cfg.optim.iterations = 2
    train.train(cfg, device="cpu")
    assert "Restored checkpoint" in capsys.readouterr().err
    _, state, _ = LogManager.restore_checkpoint(tmp_path / "ckpt_000001.npz")
    assert int(state.opt_state.step) == 2  # the curvature was carried on


def test_jax_checkpoint_resumes_in_the_port_and_back(tmp_path):
    # A JAX checkpoint with a KfacState (pickled as the JAX package's class) is
    # resumed by the port with its curvature; the port's checkpoint is read by
    # the JAX package, whose validate_opt_state drops the port's state with a
    # warning instead of crashing.
    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    cfg = tiny_config(port_dir, "batch_size=8", "optim.iterations=9")
    cfg.log.restore_path = str(jax_dir)
    jcfg = jax_config.Config.from_dict({**config.to_dict(cfg), "log": {"save_path": str(jax_dir)}})
    params = random_params(2, config.to_dict(cfg))
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    fresh = optimizers.make_optimizer_step(cfg, model)[0](model, None)
    rng = np.random.default_rng(0)

    def spd(n):
        m = rng.standard_normal((n, n)).astype(np.float32)
        return m @ m.T / n

    jstate = jax_kfac.KfacState(
        kron={k: {"a": spd(v["a"].shape[0]), "g": spd(v["g"].shape[0])} for k, v in fresh.kron.items()},
        diag={k: {n: rng.uniform(0, 1, v[n].shape).astype(np.float32) for n in v}
              for k, v in fresh.diag.items()},
        weight=np.float32(0.5), step=np.int32(6),
    )
    JaxLogManager(jcfg).save_checkpoint(
        6, JaxCheckpointState(params, random_walkers(1, 8, 3), jstate, np.float32(0.1)))

    _, restored, _ = LogManager.restore_checkpoint(jax_dir / "ckpt_000006.npz")
    assert isinstance(restored.opt_state, KfacState)
    np.testing.assert_array_equal(restored.opt_state.kron["PsiformerLayers_0/Dense_0"]["a"],
                                  jstate.kron["PsiformerLayers_0/Dense_0"]["a"])
    history = train.train(cfg, device="cpu")
    assert len(history) == 2  # steps 7 and 8, no burn-in
    _, state, _ = LogManager.restore_checkpoint(port_dir / "ckpt_000008.npz")
    ema = cfg.optim.kfac.curvature_ema
    assert int(state.opt_state.step) == 8
    assert float(state.opt_state.weight) == pytest.approx(ema * (ema * 0.5 + 1 - ema) + 1 - ema)

    _, jrestored, _ = JaxLogManager.restore_checkpoint(port_dir / "ckpt_000008.npz")
    assert isinstance(jrestored.opt_state, dict) and jrestored.opt_state["optimizer"] == "kfac"
    for name, value in flatten(jrestored.params).items():
        np.testing.assert_array_equal(value, flatten(state.params)[name])
    messages = []
    handler = logging.Handler()
    handler.emit = lambda record: messages.append(record.getMessage())
    logger = logging.getLogger("deephall")
    logger.addHandler(handler)
    try:
        assert jax_optimizers.validate_opt_state(jcfg, jrestored.opt_state) is None
    finally:
        logger.removeHandler(handler)
    assert messages == ["Restored opt_state (dict) does not match optimizer kfac; reinitialising"]
