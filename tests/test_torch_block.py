"""The port's iteration block against the JAX package's, and its invariances.

The width adaptation runs on the device inside the block; it is held against
``deephall_tpu/train.py:make_iteration_block`` with stub sweeps that replay one
acceptance sequence.  Through the port's training loop, the same seed gives
the same CSV rows and the same checkpoint whatever ``optim.block_size`` groups
the iterations into blocks, and ``log.profile_dir`` writes a trace.
"""

from __future__ import annotations

import csv
import json

import jax
import numpy as np
import pytest
import torch
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.train import make_iteration_block as jax_make_iteration_block
from deephall_tpu.types import CheckpointState as JaxState
from deephall_tpu_torch import config, train
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import flatten

torch.set_num_threads(2)

ADAPT, STEPS = 100, 250
TINY = [
    "seed=5", "batch_size=16", "system.nspins=[3,0]", "system.flux=2",
    "network.psiformer.num_layers=1", "network.psiformer.num_heads=1",
    "network.psiformer.heads_dim=4", "mcmc.burn_in=3", "mcmc.steps=2",
    "mcmc.adapt_frequency=4", "optim.iterations=12", "optim.optimizer=kfac",
    "system.dynamic_penalties=true", "system.lz_penalty=0.3", "system.l2_penalty=0.1",
]


def acceptance_sequence():
    # The first window's mean is above 0.55 (grow), the second's below 0.5
    # (shrink), the third between (keep); values on the float32 grid.
    rng = np.random.default_rng(0)
    means = np.repeat([0.7, 0.4, 0.52], ADAPT)[:STEPS]
    return np.float32(np.clip(means + 0.05 * rng.standard_normal(STEPS), 0, 1))


def jax_ring(seq):
    cfg = jax_config.Config.from_dict({"mcmc": {"adapt_frequency": ADAPT}})
    table = jnp.asarray(seq)

    def sweep(params, data, key, width):
        del params, key, width
        return data + 1, table[data[0, 0, 0].astype(jnp.int32)]

    def step(state, key):
        del key
        return state, {"energy": state.data[0, 0, 0]}

    block = jax_make_iteration_block(cfg, sweep, step)
    state = JaxState({}, jnp.zeros((1, 1, 2)), None, jnp.float32(0.1))
    state, _, pmoves, t, (_, pmove) = block(
        state, jax.random.PRNGKey(0), jnp.zeros(ADAPT), jnp.int32(0), STEPS)
    return float(state.mcmc_width), np.asarray(pmoves), int(t), np.asarray(pmove)


@pytest.mark.parametrize("lengths", [[STEPS], [1] * 7 + [3] * 31 + [150]])
def test_device_width_ring_matches_jax_block(lengths):
    # 250 iterations at adapt_frequency 100: the width grows at t = 100 and
    # shrinks at t = 200, on the device, in one block or in many.
    seq = acceptance_sequence()
    jwidth, jpmoves, jt, jpmove = jax_ring(seq)
    table = torch.from_numpy(seq)

    def sweep(data, width):
        del width
        return data + 1, table[data[0, 0, 0].long()]

    def step(state, penalties):
        del penalties
        return state, {"energy": state.data[0, 0, 0]}

    block = train.make_iteration_block(
        config.Config.from_dict({"mcmc": {"adapt_frequency": ADAPT}}), sweep, step)
    state = CheckpointState(None, torch.zeros((1, 1, 2)), None, torch.tensor(0.1))
    pmoves, t, seen = torch.zeros(ADAPT), torch.tensor(0, dtype=torch.int32), []
    for length in lengths:
        state, pmoves, t, stats, pmove = block(state, pmoves, t, length)
        assert stats["energy"].shape == pmove.shape == (length,)
        seen.append(pmove)
    np.testing.assert_array_equal(torch.cat(seen).numpy(), jpmove)
    assert int(t) == jt == STEPS
    np.testing.assert_array_equal(pmoves.numpy(), jpmoves)
    # float32 both; XLA folds the division by 1.1 into a product with its reciprocal.
    assert state.mcmc_width.dtype == torch.float32
    np.testing.assert_allclose(float(state.mcmc_width), jwidth, rtol=1e-6)
    np.testing.assert_allclose(jwidth, 0.1, rtol=1e-6)  # grown, then shrunk back


def run(tmp_path, block_size, *extra):
    save = tmp_path / f"block{block_size}"
    history = train.cli([*TINY, f"optim.block_size={block_size}", f"log.save_path={save}", *extra,
                         "--device", "cpu"])
    with open(save / "train_stats.csv") as f:
        rows = [{k: v for k, v in row.items() if k != "step_time"} for row in csv.DictReader(f)]
    return save, history, rows


@pytest.fixture(scope="module")
def one_per_block(tmp_path_factory):
    return run(tmp_path_factory.mktemp("partition"), 1)


@pytest.mark.parametrize("block_size", [3, 10])
def test_partition_invariance(one_per_block, tmp_path, block_size):
    # KFAC with dynamic penalties, 12 iterations in blocks of 1, 3 or 10 (10 + 2):
    # the same draws in the same order, so rows and checkpoints are identical.
    save1, history1, rows1 = one_per_block
    save, history, rows = run(tmp_path, block_size)
    assert len(rows) == len(history) == 12 and rows == rows1
    assert [row["step"] for row in history] == list(range(12))
    step, state, adapt = LogManager.restore_checkpoint(save / "ckpt_000011.npz")
    step1, state1, adapt1 = LogManager.restore_checkpoint(save1 / "ckpt_000011.npz")
    assert step == step1 == 12 and sorted(p.name for p in save.glob("ckpt_*")) == ["ckpt_000011.npz"]
    np.testing.assert_array_equal(state.data, state1.data)
    assert state.mcmc_width == state1.mcmc_width
    for name, value in flatten(state.params).items():
        np.testing.assert_array_equal(value, flatten(state1.params)[name], err_msg=name)
    for block in ("kron", "diag"):
        for path, leaves in getattr(state.opt_state, block).items():
            for leaf, value in leaves.items():
                np.testing.assert_array_equal(value, getattr(state1.opt_state, block)[path][leaf])
    assert int(state.opt_state.step) == int(state1.opt_state.step) == 12
    np.testing.assert_array_equal(adapt["pmoves"], adapt1["pmoves"])
    assert int(adapt["t"]) == int(adapt1["t"]) == 12


def test_profile_dir_writes_a_trace(tmp_path):
    # The trace covers the blocks that reach iterations [4, 6) of the run.
    save, history, _ = run(tmp_path, 3, f"log.profile_dir={tmp_path / 'trace'}",
                           "log.profile_start=4", "log.profile_steps=2")
    assert len(history) == 12
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {event.get("name", "") for event in trace["traceEvents"]}
    assert any("aten::" in name for name in names)


def test_block_statistics_are_read_once_per_block(tmp_path, monkeypatch):
    # The loop copies a block's statistics to the host in one read.
    calls = []
    rows = train.host_rows

    def counting(stats, pmove):
        calls.append(int(pmove.shape[0]))
        return rows(stats, pmove)

    monkeypatch.setattr(train, "host_rows", counting)
    run(tmp_path, 5)
    assert calls == [5, 5, 2]
