"""The port's configuration and checkpoints against the JAX package's.

Sidecars must parse to the same config in both packages, checkpoints must move
both ways with equal contents, and a full restore plus an inference step must
leave JAX and ``deephall_tpu`` unimported.
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
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.log import LogManager as JaxLogManager
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.types import CheckpointState, KfacState
from deephall_tpu_torch.weights import load_flax, params_from_flax, params_to_flax

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "artifacts/prod_r4"
SIDECARS = sorted(REPO.glob("artifacts/**/config.yml"))


def flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_trees_equal(a, b):
    fa, fb = flat(a), flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("path", SIDECARS, ids=lambda p: str(p.relative_to(REPO)))
def test_sidecar_parses_identically(path):
    raw = yaml.safe_load(path.read_text())
    assert config.to_dict(config.Config.from_dict(raw)) == jax_config.to_dict(
        jax_config.Config.from_dict(raw)
    )


def test_dotlist_merge_matches():
    dotlist = ["system.lz_center=${system.flux}", "system.nspins=[4, 1]", "optim.optimizer=none"]

    def merged(mod):
        cfg = mod.merge_dicts(mod.to_dict(mod.Config(seed=3)), yaml.safe_load((ARTIFACT / "config.yml").read_text()))
        cfg = mod.resolve_interpolations(mod.merge_dicts(cfg, mod.dotlist_to_dict(dotlist)))
        return mod.to_dict(mod.Config.from_dict(cfg))

    ours, theirs = merged(config), merged(jax_config)
    assert ours == theirs
    assert ours["system"]["lz_center"] == 15.0 and ours["system"]["nspins"] == [4, 1]


def test_restore_write_back_read_by_jax(tmp_path):
    step, state, adapt = LogManager.restore_checkpoint(ARTIFACT / "ckpt_019999.npz")
    # The JAX package's KfacState, read through the restricted unpickler.
    assert step == 20000 and isinstance(state.opt_state, KfacState)
    assert int(state.opt_state.step) == 20000
    cfg = config.Config.from_dict(yaml.safe_load((ARTIFACT / "config.yml").read_text()))
    model = make_network(cfg.system, cfg.network)
    load_flax(model, state.params)
    cfg.log.save_path = str(tmp_path)
    LogManager(cfg).save_checkpoint(
        step - 1,
        CheckpointState(params_to_flax(model), state.data, None, state.mcmc_width),
        adapt=adapt,
    )
    jstep, jstate, jadapt = JaxLogManager.restore_checkpoint(tmp_path / "ckpt_019999.npz")
    with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
        original = f["params"].tolist()
        data, width = f["data"], f["mcmc_width"]
        pmoves, t = f["pmoves"], f["t"]
    assert jstep == step
    assert_trees_equal(jstate.params, original)
    np.testing.assert_array_equal(jstate.data, data)
    assert jstate.mcmc_width == width
    np.testing.assert_array_equal(jadapt["pmoves"], pmoves)
    assert int(jadapt["t"]) == int(t)
    assert jstate.opt_state is None


@pytest.mark.parametrize("source", ["artifact", "jax_init"])
def test_params_round_trip(source):
    if source == "artifact":
        with np.load(ARTIFACT / "ckpt_019999.npz", allow_pickle=True) as f:
            tree = f["params"].tolist()
        raw = yaml.safe_load((ARTIFACT / "config.yml").read_text())
    else:
        raw = {
            "system": {"nspins": [3, 2], "flux": 4},
            "network": {"orbital": "sparse", "psiformer": {
                "num_layers": 1, "num_heads": 2, "heads_dim": 8, "determinants": 2}},
        }
        jcfg = jax_config.Config.from_dict(raw)
        jmodel = jax_make_network(jcfg.system, jcfg.network)
        tree = jax.tree.map(
            np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.zeros((5, 2)))
        )
    cfg = config.Config.from_dict(raw)
    model = make_network(cfg.system, cfg.network)
    state = params_from_flax(tree)
    assert set(state) == {k for k, _ in model.named_parameters()}
    load_flax(model, tree)
    assert_trees_equal(params_to_flax(model), tree)


def test_restore_and_step_import_no_jax():
    script = textwrap.dedent(
        """
        import sys
        import yaml
        import torch
        torch.set_num_threads(2)
        from deephall_tpu_torch.config import Config
        from deephall_tpu_torch.log import LogManager
        from deephall_tpu_torch.networks import make_network
        from deephall_tpu_torch.optimizers import make_optimizer_step
        from deephall_tpu_torch.weights import load_flax
        from deephall_tpu_torch.hamiltonian import local_energy
        from deephall_tpu_torch.networks.edstate import make_ed_network
        from deephall_tpu_torch.networks.laughlin import Laughlin
        from deephall_tpu_torch.observables import ed

        small = Config.from_dict({"system": {"nspins": [3, 0], "flux": 6}}).system
        ed_state, result = make_ed_network(small)
        assert isinstance(result, ed.EDResult)
        walkers = torch.rand(2, 3, 2) + 0.2
        for network in (Laughlin((3, 0), 6), ed_state):
            el, _ = torch.func.vmap(local_energy(network, small))(walkers)
            assert torch.isfinite(el).all()

        cfg = Config.from_dict(yaml.safe_load(open("artifacts/prod_r4/config.yml")))
        cfg.optim.optimizer = "none"
        _, state, _ = LogManager.restore_checkpoint("artifacts/prod_r4/ckpt_019999.npz")
        model = make_network(cfg.system, cfg.network)
        load_flax(model, state.params)
        model.requires_grad_(False)
        _, step = make_optimizer_step(cfg, model)
        state = state._replace(data=torch.as_tensor(state.data[:4]))
        _, stats = step(state)
        assert torch.isfinite(stats["energy"].real)
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
