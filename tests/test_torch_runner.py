"""The port's observable runner and fsspec paths, against the JAX package.

* ``tests/test_runner.py``'s flow through the port: train, ``load_run``,
  ``evaluate_observable(..., "overlap")`` (1 within 1e-4) and ``cli --out``;
* the runner's width cadence, ``max(1, min(adapt_frequency, steps // 5))``,
  equals ``deephall_tpu.mcmc.update_mcmc_width``'s widths on the same
  acceptances (float32, exactly);
* the ``memory://`` round trip of ``tests/test_checkpoint.py`` through the
  port's ``LogManager``, and checkpoints across the packages through one
  ``memory://`` filesystem, both ways (``load_run`` and a fixed lower state
  through the URL);
* a local run with ``fsspec`` unimportable;
* the runner and the estimators import and run with no JAX in the process.
"""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import mcmc as jax_mcmc
from deephall_tpu.log import LogManager as JaxLogManager
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.observables import load_run as jax_load_run
from deephall_tpu.types import CheckpointState as JaxCheckpointState
from deephall_tpu_torch import config, mcmc, train
from deephall_tpu_torch.log import AnyPath, LogManager
from deephall_tpu_torch.observables import evaluate_observable, load_run, runner
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import params_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
SMALL = {
    "system": {"nspins": [3, 0], "flux": 6},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 1, "heads_dim": 8,
                              "determinants": 1}},
}


def laughlin_cfg(save_path: str) -> config.Config:
    return config.Config.from_dict({
        "seed": 11, "batch_size": 64, "system": {"nspins": [3, 0], "flux": 6},
        "network": {"type": "laughlin"}, "mcmc": {"burn_in": 10},
        "optim": {"iterations": 2, "optimizer": "none"},
        "log": {"save_path": save_path, "initial_energy": False},
    })


def test_runner_on_trained_checkpoint(tmp_path):
    train.train(laughlin_cfg(str(tmp_path)), device="cpu")
    ckpt = str(tmp_path / "ckpt_000001.npz")
    run = load_run(ckpt)
    assert run[0].system.flux == 6
    results = evaluate_observable(*run, "overlap", steps=2, device="cpu")
    np.testing.assert_allclose(results["overlap"], 1.0, atol=1e-4)

    out_file = tmp_path / "density.npz"
    results = runner.cli([ckpt, "--estimator", "density", "--steps", "2", "--out",
                          str(out_file), "--device", "cpu"])
    with np.load(out_file) as f:
        assert f["map"].sum() == 2 * 64 * 3
        np.testing.assert_array_equal(f["map"], results["map"])


def test_runner_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    with pytest.raises(RuntimeError, match="CUDA was requested"):
        runner.cli([str(REPO / "artifacts/prod_r4/ckpt_019999.npz"), "--estimator", "density",
                    "--steps", "1"])


def jax_widths(pmoves_seq, adapt: int, width: float) -> list[float]:
    widths, width, ring = [], jnp.asarray(width, jnp.float32), np.zeros(adapt)
    for i, pmove in enumerate(pmoves_seq):
        width, ring = jax_mcmc.update_mcmc_width(i, width, adapt, jnp.asarray(pmove), ring)
        widths.append(float(width))
    return widths


@pytest.mark.parametrize("steps,adapt_frequency", [(3, 100), (25, 100), (40, 4)])
def test_width_cadence_matches_jax(tmp_path, monkeypatch, steps, adapt_frequency):
    """The runner's calls of ``mcmc.adapt_width`` (recorded) give JAX's widths on
    the acceptances the chain produced; and a fixed acceptance sequence through
    the runner's cadence gives JAX's widths too."""
    adapt = max(1, min(adapt_frequency, steps // 5))
    rng = np.random.default_rng(steps)
    fixed = rng.choice([0.3, 0.52, 0.8], size=steps).astype(np.float32)
    width, ring, widths = torch.tensor(0.2), torch.zeros(adapt), []
    for i, pmove in enumerate(fixed):
        width, ring = mcmc.adapt_width(i, width, ring, torch.tensor(pmove), adapt)
        widths.append(float(width))
    assert widths == jax_widths(fixed, adapt, 0.2)
    assert len(set(widths)) > 1

    calls = []

    def spy(t, width, pmoves, pmove, frequency):
        out = real(t, width, pmoves, pmove, frequency)
        calls.append((t, frequency, float(pmove), float(out[0])))
        return out

    real = mcmc.adapt_width
    monkeypatch.setattr(runner.mcmc, "adapt_width", spy)
    cfg = laughlin_cfg(str(tmp_path))
    cfg.mcmc.adapt_frequency = adapt_frequency
    model = runner.make_network(cfg.system, cfg.network)
    data = train.init_guess(torch.Generator().manual_seed(0), 32, 3, "cpu")
    evaluate_observable(cfg, model, {}, data, 0.05, "density", steps=steps, device="cpu")
    assert [c[0] for c in calls] == list(range(steps))
    assert {c[1] for c in calls} == {adapt}
    assert [c[3] for c in calls] == jax_widths([c[2] for c in calls], adapt, 0.05)


@pytest.fixture
def memory_fs():
    fsspec = pytest.importorskip("fsspec")
    fs = fsspec.filesystem("memory")
    roots = []
    yield lambda name: roots.append(name) or f"memory://{name}"
    for root in roots:
        if fs.exists(f"/{root}"):
            fs.rm(f"/{root}", recursive=True)


def psiformer_state(seed: int = 0):
    """A small Psiformer's flax parameters (JAX's init) and walkers."""
    jcfg = jax_config.Config.from_dict(SMALL)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(seed),
                                                           jnp.zeros((3, 2))))
    data = np.random.default_rng(seed).uniform(0.1, 3.0, (16, 3, 2)).astype(np.float32)
    return params, data


def assert_trees_equal(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], dict):
            assert_trees_equal(a[key], b[key])
        else:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


def test_memory_roundtrip(memory_fs):
    """Run directory, config.yml, CSV append with force_flush, checkpoints and
    the newest-first restore, all through the URL branch."""
    url = memory_fs("torch_run")
    cfg = config.Config()
    cfg.log.save_path = url
    mgr = LogManager(cfg)
    assert (AnyPath(url) / "config.yml").is_file()
    with (AnyPath(url) / "config.yml").open() as f:
        assert "flux: 2" in f.read()

    with mgr.create_writer() as writer:
        writer.log(step="0", energy="1.5")
        writer.force_flush()
        writer.log(step="1", energy="1.4")
    with mgr.create_writer() as writer:  # appends, no second header
        writer.log(step="2", energy="1.3")
    with (AnyPath(url) / "train_stats.csv").open() as f:
        assert f.read().splitlines() == ["step,energy", "0,1.5", "1,1.4", "2,1.3"]

    params, data = psiformer_state()
    mgr.save_checkpoint(7, CheckpointState(params, data, None, 0.123))
    mgr.save_checkpoint(12, CheckpointState(params, data + 1, None, 0.125),
                        adapt={"pmoves": np.full(4, 0.5, np.float32), "t": np.int32(3)})
    step, state, adapt = mgr.try_restore_checkpoint()
    assert step == 13
    assert_trees_equal(state.params, params)
    np.testing.assert_array_equal(state.data, data + 1)
    assert float(state.mcmc_width) == pytest.approx(0.125)
    assert int(adapt["t"]) == 3


def test_checkpoints_across_packages_through_memory(memory_fs):
    """JAX writes and the port reads (``load_run`` through the URL, with its
    config.yml), and the port writes and JAX reads, on one memory filesystem."""
    params, data = psiformer_state(1)
    jax_url = memory_fs("jax_run")
    jcfg = jax_config.Config.from_dict({**SMALL, "log": {"save_path": jax_url}})
    JaxLogManager(jcfg).save_checkpoint(
        4, JaxCheckpointState(params, jnp.asarray(data), None, jnp.asarray(0.07)))
    cfg, model, got_params, got_data, width = load_run(f"{jax_url}/ckpt_000004.npz")
    assert cfg.network.psiformer.heads_dim == 8
    assert_trees_equal(got_params, params)
    assert_trees_equal(params_to_flax(model), params)
    np.testing.assert_array_equal(got_data, data)
    assert width == pytest.approx(0.07)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    with torch.no_grad():
        got = model(torch.from_numpy(data)).numpy()
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(data)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    results = evaluate_observable(cfg, model, got_params, got_data, width, "density", steps=1,
                                  device="cpu")
    assert results["map"].sum() == 16 * 3
    cfg.system.orthogonal_states = [f"{jax_url}/ckpt_000004.npz"]
    (fixed,) = train.load_fixed_states(cfg, "cpu")
    np.testing.assert_array_equal(fixed(torch.from_numpy(data)).numpy(), got)
    cfg.system.orthogonal_states = []

    torch_url = memory_fs("torch_to_jax")
    cfg.log.save_path = torch_url
    LogManager(cfg).save_checkpoint(9, CheckpointState(params_to_flax(model), data * 0.5,
                                                       None, 0.09))
    jax_cfg, _, jax_params, jax_data, jax_width = jax_load_run(f"{torch_url}/ckpt_000009.npz")
    assert jax_cfg.system.flux == 6
    assert_trees_equal(jax_params, params)
    np.testing.assert_array_equal(np.asarray(jax_data), data * 0.5)
    assert float(jax_width) == pytest.approx(0.09)


def test_local_paths_need_no_fsspec(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "fsspec", None)
    train.train(laughlin_cfg(str(tmp_path)), device="cpu")
    results = runner.cli([str(tmp_path / "ckpt_000001.npz"), "--estimator", "structure_factor",
                          "--steps", "2", "--device", "cpu"])
    assert results["structure_factor"][0] == pytest.approx(3.0)
    with pytest.raises(ImportError):
        AnyPath("memory://nowhere").exists()


def test_runner_imports_no_jax():
    script = textwrap.dedent(
        """
        import sys
        import torch
        torch.set_num_threads(2)
        from deephall_tpu_torch import train
        from deephall_tpu_torch.observables import ESTIMATORS, evaluate_observable, load_run
        from deephall_tpu_torch.observables.runner import cli

        cfg = train.Config.from_dict({"system": {"nspins": [3, 0], "flux": 6},
                                      "network": {"type": "laughlin"}})
        model = train.make_network(cfg.system, cfg.network)
        data = train.init_guess(torch.Generator().manual_seed(0), 8, 3, "cpu")
        for name in sorted(ESTIMATORS):
            out = evaluate_observable(cfg, model, {}, data, 0.3, name, steps=1, device="cpu")
            assert all(torch.isfinite(torch.as_tensor(v)).all() for v in out.values()), name

        cfg, model, params, data, width = load_run("artifacts/prod_r4/ckpt_019999.npz")
        out = evaluate_observable(cfg, model, params, data[:4], width, "one_rdm", steps=1,
                                  mcmc_steps=1, device="cpu")
        assert out["one_rdm"].shape == (16, 16)
        bad = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "deephall_tpu",
                                            "fsspec"))
        assert not bad, bad
        """
    )
    out = subprocess.run(
        [sys.executable, "-c", script], cwd=REPO, capture_output=True, text=True,
        timeout=300, env={**os.environ, "PYTHONPATH": str(REPO)},
    )
    assert out.returncode == 0, out.stderr
