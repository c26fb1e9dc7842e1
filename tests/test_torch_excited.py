"""The port's excited-state losses and fixed states against the JAX package.

N = 3 at 2Q = 4, one layer of 2 heads x 4, 16 walkers drawn from a NumPy
seed; the JAX parameters of both states are carried across with
``load_flax``.  The overlap estimator is checked on random log ratios with NaN
entries and real parts of +-80, the losses with one fixed state in every mode,
``load_fixed_states`` on the system check, and the whole workflow through the
port's CLI against the exact-diagonalisation gap of JAX
``tests/test_excited.py``.  Tolerances are stated per test.
"""

from __future__ import annotations

import csv

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import loss as jax_loss
from deephall_tpu.train import load_fixed_states as jax_load_fixed_states
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config, loss, train
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import flatten, init_params, load_flax, params_to_flax

torch.set_num_threads(2)

RAW = {
    "system": {"nspins": [3, 0], "flux": 4, "overlap_penalty": 1.3},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 4}},
}
PENALTY_KEYS = ("lz_penalty", "lz_center", "l2_penalty", "l2_center", "overlap_penalty")
# The sector runs' penalties, scaled to N = 3 (artifacts/roton13/sector_*/config.yml).
SECTOR = {"lz_penalty": 1.0, "lz_center": 1.0, "l2_penalty": 0.02, "l2_center": 2.0,
          "dynamic_penalties": True}
BATCH = 16


def random_walkers(seed, batch=BATCH, nelec=3):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def random_params(seed, raw=RAW):
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(seed))
    return params_to_flax(model)


def port_model(params, raw=RAW):
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    return cfg, model


def random_log_ratios(seed, states=2, batch=BATCH, scale=1.0):
    rng = np.random.default_rng(seed)
    x = scale * rng.standard_normal((states, batch)) + 1j * rng.uniform(-np.pi, np.pi, (states, batch))
    return x.astype(np.complex64)


def log_ratio_cases():
    nan = random_log_ratios(1)
    nan[0, 3] = np.nan + 0j
    nan[1, [0, 5]] = complex(0.3, np.nan)
    large = random_log_ratios(2)
    large[0] += 80.0  # a state far above psi everywhere
    large[1] -= 80.0  # and one far below
    spread = random_log_ratios(3, scale=40.0)
    spread[1, 7] = np.nan
    return {"nan": nan, "large": large, "spread": spread}


@pytest.mark.parametrize("case", sorted(log_ratio_cases()))
def test_orthogonality_stats_and_diff_match(case):
    # Same complex64 inputs on both sides, float32 sums in another order:
    # 1e-6 of the overlap and of the largest weight.
    ratios = log_ratio_cases()[case]
    want_overlap, want_diff = jax_loss.orthogonality_stats_and_diff(jnp.asarray(ratios), 1.7)
    got_overlap, got_diff = loss.orthogonality_stats_and_diff(torch.from_numpy(ratios), 1.7)
    want_diff = np.asarray(want_diff)
    assert got_overlap.dtype == torch.float32 and got_diff.dtype == torch.complex64
    np.testing.assert_allclose(got_overlap.numpy(), np.asarray(want_overlap), rtol=1e-6)
    np.testing.assert_allclose(got_diff.numpy(), want_diff, rtol=0,
                               atol=1e-6 * np.nanmax(np.abs(want_diff)))
    assert np.array_equal(np.isnan(got_diff.numpy()), np.isnan(want_diff))


@pytest.mark.parametrize("seed", [0, 1])
def test_self_overlap_is_one_with_zero_gradient(seed):
    # phi == psi: O = 1 and every per-walker weight vanishes (JAX tests/test_excited.py:50).
    _, model = port_model(random_params(seed))
    data = torch.from_numpy(random_walkers(10 + seed))
    with torch.no_grad():
        logpsi = model(data)
    ratios = loss.fixed_state_log_ratios([model], logpsi, data)
    overlap, diff = loss.orthogonality_stats_and_diff(ratios, 2.5)
    assert abs(float(overlap) - 1.0) < 1e-6
    assert diff.abs().max() < 1e-6


def synthetic_observables(seed, batch=BATCH):
    rng = np.random.default_rng(seed)
    el = (3.1 + 0.1 * rng.standard_normal(batch) + 0.01j * rng.standard_normal(batch)).astype(np.complex64)
    el[2] += 30.0  # an outlier for the clipping
    obs = {
        "angular_momentum_z": 1.0 + 0.1 * rng.standard_normal(batch),
        "angular_momentum_z_square": 1.0 + np.abs(rng.standard_normal(batch)),
        "angular_momentum_square": 2.0 + np.abs(rng.standard_normal(batch)),
        "potential": 1.6 + 0.1 * rng.standard_normal(batch),
        "kinetic": (1.5 + 0.1 * rng.standard_normal(batch)).astype(np.complex64),
    }
    return el, {k: np.asarray(v, np.complex64 if np.iscomplexobj(v) else np.float32) for k, v in obs.items()}


@pytest.mark.parametrize("dynamic", [False, True])
def test_stats_and_clipped_diff_with_overlap_match(dynamic):
    # The energy, penalty and overlap terms together; 1e-6 of each statistic
    # and of the largest difference (float32 sums in another order).
    raw = {"system": {**RAW["system"], **SECTOR, "dynamic_penalties": dynamic}}
    jsystem, system = jax_config.Config.from_dict(raw).system, config.Config.from_dict(raw).system
    el, obs = synthetic_observables(4)
    ratios = random_log_ratios(5, states=1)
    jpen = {k: jnp.float32(getattr(jsystem, k)) for k in PENALTY_KEYS} if dynamic else None
    tpen = {k: torch.tensor(float(getattr(system, k))) for k in PENALTY_KEYS} if dynamic else None
    want_stats, want_diff = jax_loss.stats_and_clipped_diff(
        jsystem, jnp.asarray(el), {k: jnp.asarray(v) for k, v in obs.items()},
        jnp.asarray(ratios), jpen)
    got_stats, got_diff = loss.stats_and_clipped_diff(
        system, torch.from_numpy(el), {k: torch.from_numpy(v) for k, v in obs.items()},
        torch.from_numpy(ratios), tpen)
    assert "overlap" in got_stats and sorted(got_stats) == sorted(want_stats)
    for key, want in want_stats.items():
        np.testing.assert_allclose(got_stats[key].numpy(), np.asarray(want), rtol=1e-6, err_msg=key)
    want_diff = np.asarray(want_diff)
    np.testing.assert_allclose(got_diff.numpy(), want_diff, rtol=0, atol=1e-6 * np.abs(want_diff).max())


@pytest.fixture(scope="module")
def jax_losses():
    """The JAX package's losses with one fixed state, on the same parameters and walkers."""
    raw = {**RAW, "system": {**RAW["system"], **SECTOR}}
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params, params_phi = random_params(3, raw), random_params(4, raw)
    data = jnp.asarray(random_walkers(7))
    fixed = [lambda d: jmodel.apply(params_phi, d)]
    penalties = {k: jnp.float32(getattr(jcfg.system, k)) for k in PENALTY_KEYS}
    fns = {m: jax_loss.make_loss_fn(jmodel.apply, jcfg.system, jax_loss.LossMode[m], model=jmodel,
                                    fixed_states=fixed)
           for m in ("ENERGY_GRAD", "SR_F_VECTOR", "ENERGY_DIFF")}
    capture = jax_loss.make_loss_and_capture_fn(jcfg.system, jmodel, fixed_states=fixed)
    out = {m: jax.jit(fn)(params, data, penalties) for m, fn in fns.items()}
    out["capture"] = jax.jit(capture)(params, data, penalties)
    return raw, params, params_phi, np.asarray(data), jax.tree.map(np.asarray, out)


def port_losses(jax_losses):
    raw, params, params_phi, data, _ = jax_losses
    cfg, model = port_model(params, raw)
    _, phi = port_model(params_phi, raw)
    phi.requires_grad_(False)
    penalties = train.penalty_operands(cfg, "cpu")
    return cfg, model, [phi], torch.from_numpy(data.copy()), penalties


def assert_leaves_close(got: dict, want: dict):
    """1e-4 of each leaf's largest value, a leaf's scale at least 1e-4 of the
    whole gradient's largest value (tests/test_torch_train.py says why)."""
    largest = max(np.abs(v).max() for v in want.values())
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        g, w = g.numpy(), want[name]
        assert np.iscomplexobj(g) == np.iscomplexobj(w), name
        for part in (np.real, np.imag) if np.iscomplexobj(w) else (np.real,):
            scale = max(np.abs(part(w)).max(), 1e-4 * largest)
            assert np.abs(part(g) - part(w)).max() < 1e-4 * scale, (name, part.__name__)


def assert_stats_close(got: dict, want: dict):
    assert sorted(got) == sorted(want) and "overlap" in got
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w, rtol=1e-4, atol=1e-5, err_msg=key)


@pytest.mark.parametrize("mode", ["ENERGY_GRAD", "SR_F_VECTOR"])
def test_gradients_with_a_fixed_state_match(jax_losses, mode):
    cfg, model, fixed, data, penalties = port_losses(jax_losses)
    want_stats, want = jax_losses[-1][mode]
    stats, grads = loss.make_loss_fn(model, cfg.system, loss.LossMode[mode], fixed)(data, penalties)
    assert_stats_close(stats, want_stats)
    assert_leaves_close(grads, flatten(want))


def test_energy_diff_with_a_fixed_state_matches(jax_losses):
    # The inference loss: the current log psi from one more forward.
    cfg, model, fixed, data, penalties = port_losses(jax_losses)
    model.requires_grad_(False)
    want_stats, want_diff = jax_losses[-1]["ENERGY_DIFF"]
    stats, diff = loss.make_loss_fn(model, cfg.system, loss.LossMode.ENERGY_DIFF, fixed)(data, penalties)
    assert_stats_close(stats, want_stats)
    np.testing.assert_allclose(diff.numpy(), want_diff, rtol=0, atol=1e-4 * np.abs(want_diff).max())


def test_kfac_capture_with_a_fixed_state_matches(jax_losses):
    # The ratios take the primal of the captured forward: the gradient, every
    # layer's input and its Fisher sensitivity as without a fixed state.
    from deephall_tpu.optimizers import kfac as jax_kfac

    cfg, model, fixed, data, penalties = port_losses(jax_losses)
    want_stats, want_grads, sown, dy = jax_losses[-1]["capture"]
    stats, grads, inputs, got_dy = loss.make_loss_and_capture_fn(model, cfg.system, fixed)(data, penalties)
    assert_stats_close(stats, want_stats)
    assert_leaves_close(grads, flatten(want_grads))
    sown = {jax_kfac._path_key(k): v for k, v in jax_kfac._module_paths(sown).items()}
    dy = {jax_kfac._path_key(k): v for k, v in jax_kfac._module_paths(dy).items()}
    assert sorted(inputs) == sorted(sown) == sorted(got_dy) == sorted(dy)
    for path in inputs:
        want_in, want_dy = np.asarray(sown[path]), np.asarray(dy[path])
        assert np.abs(inputs[path].numpy() - want_in).max() < 1e-5 * np.abs(want_in).max(), path
        assert np.abs(got_dy[path].numpy() - want_dy).max() < 1e-4 * np.abs(want_dy).max(), path


def stored_state(tmp_path, name, raw, seed):
    """A run directory with a config sidecar and one checkpoint of random parameters."""
    cfg = config.Config.from_dict({**raw, "log": {"save_path": str(tmp_path / name)}})
    params = random_params(seed, raw)
    LogManager(cfg).save_checkpoint(0, CheckpointState(params, random_walkers(1), None, 0.1))
    return tmp_path / name / "ckpt_000000.npz", params


def test_load_fixed_states_refuses_another_flux(tmp_path):
    other = {**RAW, "system": {**RAW["system"], "flux": 2}}
    path, _ = stored_state(tmp_path, "other", other, 1)
    raw = {**RAW, "system": {**RAW["system"], "orthogonal_states": [str(path)]}}
    with pytest.raises(ValueError) as got:
        train.load_fixed_states(config.Config.from_dict(raw), "cpu")
    with pytest.raises(ValueError) as want:
        jax_load_fixed_states(jax_config.Config.from_dict(raw))
    assert str(got.value) == str(want.value)
    assert "different system" in str(got.value)


def test_load_fixed_states_give_the_stored_log_psi(tmp_path):
    # A fixed state is a frozen float32 module: its log phi equals the JAX
    # package's on the same walkers (1e-5 of the largest value) and carries no graph.
    path, params = stored_state(tmp_path, "ground", RAW, 2)
    raw = {**RAW, "system": {**RAW["system"], "orthogonal_states": [str(path)]}}
    (got,) = train.load_fixed_states(config.Config.from_dict(raw), "cpu")
    (want,) = jax_load_fixed_states(jax_config.Config.from_dict(raw))
    data = random_walkers(3)
    value = got(torch.from_numpy(data))
    assert not value.requires_grad and value.dtype == torch.complex64
    expected = np.asarray(want(jnp.asarray(data)))
    assert np.abs(value.numpy() - expected).max() < 1e-5 * np.abs(expected).max()


def tail_mean(csv_path, column, rows=100):
    with open(csv_path) as f:
        table = list(csv.DictReader(f))
    return float(np.mean([float(r[column]) for r in table[-rows:]]))


def test_excited_state_end_to_end(tmp_path):
    # JAX tests/test_excited.py:144-200 through the port's CLI on the CPU.
    # N=3, 2Q=4, Lz=0 is a two-state block: the L=1 ground multiplet at
    # E0 = 2.96098 and the L=3 excited one at E1 = 3.12266.  The ground state
    # is trained with the Lz and L^2 penalties, then the excited state from
    # scratch against it with the overlap penalty: it must land at E1, L^2 ~ 12,
    # with a vanishing overlap.  Oracles and tolerances are the JAX test's.
    from deephall_tpu.observables import ed

    block = ed.ed_block(3, 4, two_lz=0)
    assert block.dim == 2
    e0 = block.total_energy(3)
    e1 = e0 + float(block.energies[1] - block.energies[0])
    common = [
        "batch_size=256", "system.nspins=[3, 0]", "system.flux=4", "system.lz_penalty=1.0",
        "network.psiformer.num_layers=1", "network.psiformer.num_heads=1",
        "network.psiformer.heads_dim=8", "mcmc.burn_in=30", "optim.iterations=500",
        "optim.optimizer=kfac", "optim.block_size=10", "log.initial_energy=false",
    ]
    ground = tmp_path / "ground"
    train.cli([*common, "seed=7", "system.l2_penalty=0.5", f"log.save_path={ground}",
               "--device", "cpu"])
    ground_energy = tail_mean(ground / "train_stats.csv", "energy")
    assert abs(ground_energy - e0) < 0.06, (ground_energy, e0)
    assert tail_mean(ground / "train_stats.csv", "L_square") < 3.0

    excited = tmp_path / "excited"
    train.cli([*common, "seed=11", f"system.orthogonal_states=[{ground}/ckpt_000499.npz]",
               "system.overlap_penalty=1.0", f"log.save_path={excited}", "--device", "cpu"])
    stats = excited / "train_stats.csv"
    excited_energy = tail_mean(stats, "energy")
    assert abs(excited_energy - e1) < 0.08, (excited_energy, e1)
    assert tail_mean(stats, "L_square") > 10.0
    assert tail_mean(stats, "overlap") < 0.1
    assert excited_energy - ground_energy > 0.08  # exact gap: 0.162
