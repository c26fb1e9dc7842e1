"""The port's KFAC (capture, factors, one step, state) against the JAX package.

A small Psiformer (N = 3 with both spin sectors, 2Q = 4, one layer of 2 heads
x 4, Coulomb, L^2 on) at 16 walkers drawn from a NumPy seed; the JAX
parameters are carried across with ``load_flax``.  Tolerances are stated per
test; the measured errors are recorded in ``PERF.md``.
"""

from __future__ import annotations

import logging
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu import loss as jax_loss
from deephall_tpu import optimizers as jax_optimizers
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu.optimizers import kfac as jax_kfac
from deephall_tpu.types import CheckpointState as JaxCheckpointState
from deephall_tpu_torch import config, optimizers
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.loss import make_loss_and_capture_fn
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.optimizers import kfac
from deephall_tpu_torch.types import AdamState, CheckpointState, KfacState
from deephall_tpu_torch.weights import flatten, init_params, load_flax, params_to_flax

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts/prod_r4"
RAW = {
    "system": {"nspins": [2, 1], "flux": 4},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 4}},
}
BATCH = 16


def random_walkers(seed, batch, nelec):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return np.stack([theta, phi], axis=-1).astype(np.float32)


def max_rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's capture and two KFAC steps (from zeros, then from the first's state)."""
    jcfg = jax_config.Config.from_dict(RAW)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    cfg, model = port_model(None)
    init_params(model, torch.Generator().manual_seed(5))
    params = params_to_flax(model)
    data = random_walkers(11, BATCH, 3)
    capture_fn = jax.jit(jax_loss.make_loss_and_capture_fn(jcfg.system, jmodel))
    _, step = jax_kfac.make_kfac_training_step(
        jcfg.optim.kfac, None, jmodel, jnp.zeros((3, 2)), capture_fn=capture_fn
    )
    _, _, sown, dy = capture_fn(params, data)
    # Zero curvature with the blocks of the port's init; the JAX step's result
    # holds the JAX package's own keys and shapes (test_discovery_matches).
    state0 = jax_kfac.KfacState(*(
        jax.tree.map(lambda t: t.numpy(), f) if isinstance(f, dict) else f.numpy()
        for f in optimizers.make_optimizer_step(cfg, model)[0](model, None)))
    step = jax.jit(step)
    out1, _ = step(JaxCheckpointState(params, data, state0, jnp.float32(0.1)), None)
    out2, _ = step(out1, None)
    return dict(
        cfg=jcfg, params=params, data=data, state0=state0,
        sown={jax_kfac._path_key(k): np.asarray(v) for k, v in jax_kfac._module_paths(sown).items()},
        dy={jax_kfac._path_key(k): np.asarray(v) for k, v in jax_kfac._module_paths(dy).items()},
        steps=[(numpy_tree(out.params), numpy_tree(out.opt_state)) for out in (out1, out2)],
    )


def port_model(params):
    cfg = config.Config.from_dict(RAW)
    model = make_network(cfg.system, cfg.network)
    if params is not None:
        load_flax(model, params)
    return cfg, model


def to_port_state(jstate) -> KfacState:
    return optimizers.state_to(KfacState(*jstate), "cpu")


def test_capture_matches(jax_run):
    # Layer inputs are float32 activations (1e-5 of each layer's largest
    # value); the sensitivities are backward passes through the complex LU
    # summed in another order (1e-4).
    cfg, model = port_model(jax_run["params"])
    _, _, inputs, dy = make_loss_and_capture_fn(model, cfg.system)(torch.from_numpy(jax_run["data"]))
    assert sorted(inputs) == sorted(jax_run["sown"]) == sorted(dy) == sorted(jax_run["dy"])
    for path in inputs:
        assert max_rel(inputs[path].numpy(), jax_run["sown"][path]) < 1e-5, path
        assert max_rel(dy[path].numpy(), jax_run["dy"][path]) < 1e-4, path


def test_factors_match(jax_run):
    # One step from zero curvature: the JAX state holds (1 - ema) x the new
    # factors, and its weight (1 - ema); 1e-4 of each block's largest entry.
    cfg, model = port_model(jax_run["params"])
    _, _, inputs, dy = make_loss_and_capture_fn(model, cfg.system)(torch.from_numpy(jax_run["data"]))
    specs = kfac.discover(model, 3)
    kron, diag = kfac.factor_update(specs, inputs, dy)
    _, jstate = jax_run["steps"][0]
    weight = float(jstate.weight)
    assert weight == pytest.approx(1 - cfg.optim.kfac.curvature_ema)
    for blocks, want_blocks in ((kron, jstate.kron), (diag, jstate.diag)):
        assert sorted(blocks) == sorted(want_blocks)
        for path, block in blocks.items():
            for leaf, value in block.items():
                assert max_rel(value.numpy(), want_blocks[path][leaf] / weight) < 1e-4, (path, leaf)


def test_discovery_matches(jax_run):
    # The port's init has the blocks, fan-ins (a bias column where the layer
    # has a bias) and shapes of the JAX package's state after a step, in zeros.
    cfg, model = port_model(jax_run["params"])
    init, _ = optimizers.make_optimizer_step(cfg, model)
    state = init(model, None)
    want = jax_run["steps"][0][1]
    for got, ref in ((state.kron, want.kron), (state.diag, want.diag)):
        assert sorted(got) == sorted(ref)
        for path, block in got.items():
            assert {k: tuple(v.shape) for k, v in block.items()} == {
                k: v.shape for k, v in ref[path].items()}, path
            assert all(not v.any() for v in block.values())
    assert state.weight.item() == 0 and state.step.dtype == torch.int32 and state.step.item() == 0
    specs = {s.path: s.repeats for s in kfac.discover(model, 3)}
    assert specs["PsiformerLayers_0/Dense_0"] == 3
    assert specs["Orbitals_0/featured_orbitals/DenseGeneral_0"] == 2  # spin-up rows
    assert specs["Orbitals_0/featured_orbitals/DenseGeneral_2"] == 1  # spin-down rows


@pytest.mark.parametrize("start", [0, 1], ids=["from_zero_curvature", "from_a_step"])
def test_kfac_step_matches(jax_run, start):
    # One KFAC step from the same parameters, walkers and curvature: the
    # parameter update to 1e-3 of each leaf's largest update (the solves
    # amplify the float32 differences of the factors), the new state to 1e-4.
    if start == 0:
        params, jstate = jax_run["params"], jax_run["state0"]
    else:
        params, jstate = jax_run["steps"][0]
    want_params, want_state = jax_run["steps"][start]
    cfg, model = port_model(params)
    _, step = optimizers.make_optimizer_step(cfg, model)
    state, stats = step(CheckpointState(None, torch.from_numpy(jax_run["data"]), to_port_state(jstate), 0.1))
    before, after, want = flatten(params), flatten(params_to_flax(model)), flatten(want_params)
    for name in before:
        update, want_update = after[name] - before[name], want[name] - before[name]
        assert max_rel(update, want_update) < 1e-3, name
    opt = state.opt_state
    assert int(opt.step) == int(want_state.step) == start + 1
    assert float(opt.weight) == pytest.approx(float(want_state.weight), rel=1e-6)
    for got_blocks, want_blocks in ((opt.kron, want_state.kron), (opt.diag, want_state.diag)):
        for path, block in got_blocks.items():
            for leaf, value in block.items():
                assert max_rel(value.numpy(), want_blocks[path][leaf]) < 1e-4, (path, leaf)
    lr = cfg.optim.kfac.lr.schedule(start)
    assert float(stats["learning_rate"]) == pytest.approx(lr)
    assert 0 < float(stats["norm_coefficient"]) <= 1
    # The norm constraint: lr^2 coeff^2 d^T F d <= c.
    quad = float(stats["quadratic_norm"])
    assert lr**2 * float(stats["norm_coefficient"]) ** 2 * quad <= cfg.optim.kfac.norm_constraint * (1 + 1e-5)


def test_production_state_loads_into_the_port():
    # The restricted unpickler reads the JAX package's KfacState of the N=6
    # production run; the port's init has the same blocks, keys and shapes.
    _, state, _ = LogManager.restore_checkpoint(ARTIFACT / "ckpt_019999.npz")
    restored = state.opt_state
    assert isinstance(restored, KfacState)
    assert int(restored.step) == 20000
    assert float(restored.weight) == pytest.approx(0.99999946, rel=1e-6)
    assert len(restored.kron) == 15 and len(restored.diag) == 4
    cfg = config.Config.from_dict(yaml.safe_load((ARTIFACT / "config.yml").read_text()))
    model = make_network(cfg.system, cfg.network)
    init, _ = optimizers.make_optimizer_step(cfg, model)
    fresh = init(model, None)
    for got, ref in ((fresh.kron, restored.kron), (fresh.diag, restored.diag)):
        assert sorted(got) == sorted(ref)
        for path, block in got.items():
            assert {k: tuple(v.shape) for k, v in block.items()} == {
                k: v.shape for k, v in ref[path].items()}, path
    assert optimizers.validate_opt_state(cfg, restored) is restored


def jax_kfac_state():
    return jax_kfac.KfacState(kron={}, diag={}, weight=np.float32(1), step=np.int32(3))


STATES = {
    "adam_under_kfac": ("kfac", lambda: AdamState(np.int32(1), {}, {}), "AdamState"),
    "kfac_under_adam": ("adam", lambda: KfacState({}, {}, np.float32(1), np.int32(3)), "KfacState"),
    "dict_under_kfac": ("kfac", lambda: {"optimizer": "other"}, "dict"),
    "kfac_under_none": ("none", lambda: KfacState({}, {}, np.float32(1), np.int32(3)), None),
}


class Messages(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)
        self.messages: list[str] = []

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.mark.parametrize("case", sorted(STATES))
def test_validate_opt_state_drops_mismatches(case):
    # The same decision and the same warning text as the JAX package's
    # validate_opt_state, which is given the JAX counterpart of each state.
    optimizer, make_state, type_name = STATES[case]
    cfg = config.Config.from_dict({"optim": {"optimizer": optimizer}})
    jcfg = jax_config.Config.from_dict({"optim": {"optimizer": optimizer}})
    jax_state = {"AdamState": None, "KfacState": jax_kfac_state(), "dict": {"optimizer": "other"},
                 None: jax_kfac_state()}[type_name]
    logger = logging.getLogger("deephall")
    port, jax_side = Messages(), Messages()
    logger.addHandler(port)
    try:
        assert optimizers.validate_opt_state(cfg, make_state()) is None
    finally:
        logger.removeHandler(port)
    logger.addHandler(jax_side)
    try:
        if jax_state is not None:
            assert jax_optimizers.validate_opt_state(jcfg, jax_state) is None
    finally:
        logger.removeHandler(jax_side)
    port_messages, jax_messages = port.messages, jax_side.messages
    if type_name is None:
        assert port_messages == jax_messages == []
    else:
        want = f"Restored opt_state ({type_name}) does not match optimizer {optimizer}; reinitialising"
        assert port_messages == [want]
        if jax_state is not None:
            assert jax_messages == [want]
