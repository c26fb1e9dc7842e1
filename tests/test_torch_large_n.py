"""The port beyond N = 6 against the JAX package, and the kernels' shape limits.

The JAX package trained N = 10 (nu = 1/3, 2Q = 27, ``artifacts/prod_n10_r5``)
and N = 12 (nu = 3/7, 2Q = 23); the port's kernels take every system up to
N = 16.  Per-walker local energy and observables through both packages'
forward-Laplacian jets in float32, on the CPU (the port's plain versions, the
JAX package's chain):

* N = 10 with the stored state's full-width parameters and L^2 on.  E_L, the
  kinetic and potential energies and Lz agree within 1e-4 (rtol and atol), as
  at N = 6.  Lz^2 and L^2 are sums of large terms that cancel, and their
  float32 rounding grows with N: on 4 stored walkers, against the port's
  float64, JAX's float32 Lz^2 is off by 3.6e-4 and the port's by 1.8e-4
  (E_L by 6.7e-5 and 1.3e-5), and the two packages differ by up to 3.7e-4
  at Lz^2 ~ 0.09.  So Lz^2 and L^2 are held at atol 1e-3 (rtol 1e-4 on
  every field, as at N = 6).
* N = 12 with a narrow Psiformer (1 layer, 2 heads of 8) from the JAX init,
  both L^2 modes.  A random network is far from an eigenstate and its
  orbital matrices are worse conditioned (as in
  ``test_torch_energy.py::test_random_sparse_two_determinants``), hence
  atol 2e-3 on every field there.

The limits are pure Python: every (N <= 16, L^2 on or off) shape passes both
kernels' checks, and a shape past a limit raises a ValueError naming it.
"""

from __future__ import annotations

from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml
from jax import numpy as jnp

from deephall_tpu import config as jax_config
from deephall_tpu.hamiltonian import forward_laplacian_local_energy as jax_local_energy
from deephall_tpu.networks import make_network as jax_make_network
from deephall_tpu_torch import config
from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import jet_attention, jet_layernorm
from deephall_tpu_torch.weights import load_flax

torch.set_num_threads(2)

ARTIFACT = Path(__file__).resolve().parents[1] / "artifacts/prod_n10_r5"
FIELDS = ("energy", "kinetic", "potential", "angular_momentum_z")
CANCELLING = ("angular_momentum_z_square", "angular_momentum_square")


def both_packages(raw: dict, params, data: np.ndarray) -> tuple[dict, dict]:
    """``{field: per-walker values}`` of the JAX package and of the port."""
    jcfg = jax_config.Config.from_dict(raw)
    cfg = config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, params)
    want_el, want = jax.jit(jax_local_energy(jmodel, jcfg.system))(params, jnp.asarray(data))
    with torch.no_grad():
        got_el, got = forward_laplacian_local_energy(model, cfg.system)(torch.from_numpy(data))
    want = {"energy": want_el, **want}
    got = {"energy": got_el, **got}
    return ({k: np.asarray(v) for k, v in want.items()},
            {k: v.numpy() for k, v in got.items()})


def assert_fields(want: dict, got: dict, atol: float, cancelling_atol: float, l2: bool) -> None:
    for key in FIELDS:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=atol, err_msg=key)
    for key in CANCELLING:
        if key == "angular_momentum_square" and not l2:
            assert np.isnan(got[key]).all() and np.isnan(want[key]).all()
            continue
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=cancelling_atol,
                                   err_msg=key)


def test_n10_production_walkers():
    raw = yaml.safe_load((ARTIFACT / "config.yml").read_text())
    raw["system"]["compute_l2"] = True
    with np.load(ARTIFACT / "ckpt_027729.npz", allow_pickle=True) as f:
        params, data = f["params"].tolist(), np.asarray(f["data"][:4])
    assert data.shape == (4, 10, 2)
    want, got = both_packages(raw, params, data)
    assert_fields(want, got, atol=1e-4, cancelling_atol=1e-3, l2=True)
    # The converged state: E_L within 0.5 of 14.28 at every walker.
    assert np.all(np.abs(got["energy"].real - 14.28) < 0.5)


@pytest.mark.parametrize("compute_l2", [True, False])
def test_n12_narrow_psiformer(compute_l2):
    raw = {
        "system": {"nspins": [12, 0], "flux": 23, "compute_l2": compute_l2},
        "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 8}},
    }
    jcfg = jax_config.Config.from_dict(raw)
    jmodel = jax_make_network(jcfg.system, jcfg.network)
    params = jax.tree.map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(12), jnp.zeros((12, 2)))
    )
    rng = np.random.default_rng(23)
    data = np.stack([np.arccos(rng.uniform(-0.9, 0.9, (4, 12))),
                     rng.uniform(-np.pi, np.pi, (4, 12))], -1).astype(np.float32)
    want, got = both_packages(raw, params, data)
    assert_fields(want, got, atol=2e-3, cancelling_atol=2e-3, l2=compute_l2)


def jet_shape(nelec: int, compute_l2: bool) -> tuple[int, int]:
    """``(C, E)`` of the Psiformer's jet at N electrons (``ops/fwdlap.py``)."""
    e = 3 if compute_l2 else 1
    return 2 * nelec + e, e


@pytest.mark.parametrize("compute_l2", [True, False])
def test_kernel_limits_take_every_system_up_to_16(compute_l2):
    feat, heads = 256, 4
    for nelec in range(1, 17):
        c, e = jet_shape(nelec, compute_l2)
        jet_attention.check_softmax_values_shape(nelec, feat, heads, c, e)
        jet_layernorm.check_shape(feat, c, e)
        need = jet_attention.softmax_values_smem(nelec, feat // heads)
        assert need <= jet_attention.SV_SMEM_LIMIT
    # N = 16: T = 16, dh = 64, one head an item, one stage (the figure the wrapper's note gives).
    assert jet_attention.softmax_values_smem(16, 64) == 45_776


@pytest.mark.parametrize("compute_l2", [True, False])
def test_staged_layernorm_takes_every_system_up_to_16(compute_l2):
    """At D = 256 every jet LayerNorm of N <= 16, and of N = 30 with L^2, goes
    to the staged kernel, with a residual or without; only N = 6 with a
    residual stays on the streamed kernel.  Its row is no larger than that of
    C = 64, E = 4 with a residual, which gets one stage on the card
    (test_torch_kernels_cuda.py::test_staged_stages_on_the_card)."""
    feat, rows = 256, 3360 * 16
    largest = jet_layernorm.stage_bytes(feat, jet_layernorm.MAX_TANGENTS,
                                        jet_layernorm.MAX_EXTRAS, True)
    for nelec in [*range(1, 17), *([30] if compute_l2 else [])]:
        c, e = jet_shape(nelec, compute_l2)
        for residual in (True, False):
            assert jet_layernorm.stage_bytes(feat, c, e, residual) <= largest
            want = "streamed" if nelec == 6 and residual else "staged"
            got = jet_layernorm.route(feat, c, e, residual, rows, True, 1)
            assert got == want, (nelec, residual)


def test_kernel_limits_name_what_they_refuse():
    feat, heads = 256, 4
    c, e = jet_shape(49, True)  # 238,592 bytes of shared memory with one head and one stage
    with pytest.raises(ValueError, match="SV_SMEM_LIMIT"):
        jet_attention.check_softmax_values_shape(49, feat, heads, c, e)
    # The largest N the softmax/values kernel takes at dh = 64 is 48 in both
    # modes (its shared memory grows as T dh + T^2, with neither C nor E).
    for compute_l2 in (True, False):
        jet_attention.check_softmax_values_shape(48, feat, heads, *jet_shape(48, compute_l2))
        with pytest.raises(ValueError, match="SV_SMEM_LIMIT"):
            jet_attention.check_softmax_values_shape(49, feat, heads, *jet_shape(49, compute_l2))
    jet_layernorm.check_shape(feat, *jet_shape(30, True))  # C = 63
    with pytest.raises(ValueError, match="MAX_TANGENTS"):
        jet_layernorm.check_shape(feat, *jet_shape(31, True))  # C = 65
    with pytest.raises(ValueError, match="MAX_EXTRAS"):
        jet_layernorm.check_shape(feat, 10, 5)
    with pytest.raises(ValueError, match="D % 32"):
        jet_layernorm.check_shape(48, 15, 3)
    with pytest.raises(ValueError, match="unsupported attention shape"):
        jet_attention.check_softmax_values_shape(6, 250, 4, 15, 3)


@pytest.mark.parametrize("compute_l2", [True, False])
def test_softmax_values_takes_every_system_up_to_25(compute_l2):
    """Every N <= 25 at dh = 64 in both modes goes to a kernel on the card: the
    tiled one at N = 6, the streamed one at every other N, aligned or not."""
    feat, heads = 256, 4
    for nelec in range(1, 26):
        c, e = jet_shape(nelec, compute_l2)
        jet_attention.check_softmax_values_shape(nelec, feat, heads, c, e)
        want = "tiled" if nelec == 6 else "streamed"
        assert jet_attention.softmax_values_route(nelec, feat // heads, c, e, True) == want
        assert jet_attention.softmax_values_route(nelec, feat // heads, c, e, False) == "streamed"


@pytest.mark.parametrize("tokens,head_dim,c,e,aligned,want", [
    (6, 64, 15, 3, True, "tiled"), (6, 64, 13, 1, True, "tiled"),
    (6, 64, 15, 3, False, "streamed"), (6, 64, 14, 2, True, "streamed"),
    (6, 32, 13, 1, True, "streamed"), (8, 64, 17, 1, True, "streamed"),
    (10, 64, 23, 3, True, "streamed"), (21, 64, 45, 3, True, "streamed"),
    (3, 8, 2, 2, True, "streamed"), (5, 6, 5, 1, True, "streamed"),
])
def test_softmax_values_route(tokens, head_dim, c, e, aligned, want):
    assert jet_attention.softmax_values_route(tokens, head_dim, c, e, aligned) == want


# (T, dh, heads an item, stages): bytes.  A plane is tp rows (T rounded up to
# 4) of the group's [q | k | v] at a row stride of 3 * group * dh floats, plus
# 4 where that is a multiple of 8; the primal's copy and the ring; per head
# 6 [tp][tp] + [tp], and two slots of 3 [tp][tp] + [tp] + [tp][dh]; 16 bytes
# of mbarriers a stage.  N = 10, one head, one stage:
# 4 (2 * 12 * 196 + (6 * 144 + 12) + 2 * (3 * 144 + 12 + 12 * 64)) + 16.
@pytest.mark.parametrize("tokens,head_dim,group,stages,nbytes", [
    (10, 64, 1, 1, 32_032), (10, 64, 4, 3, 201_072), (16, 64, 4, 2, 230_944),
    (16, 64, 1, 1, 45_776), (25, 64, 2, 2, 235_008), (48, 64, 1, 1, 211_024),
    (49, 64, 1, 1, 238_592), (3, 8, 1, 1, 1_984), (5, 6, 2, 2, 12_384),
])
def test_streamed_smem(tokens, head_dim, group, stages, nbytes):
    assert jet_attention.softmax_values_smem(tokens, head_dim, group, stages) == nbytes
