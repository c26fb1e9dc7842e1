"""The training step on a card: one KFAC step against the same step on the CPU,
and the attention kernels after in-place parameter updates.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere.  Run them on
the card with

    python -m pytest tests/test_torch_train_cuda.py -m cuda
"""

from __future__ import annotations

import copy
import math

import numpy as np
import pytest
import torch

from deephall_tpu_torch import config, optimizers
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import jet_attention, jet_layernorm
from deephall_tpu_torch.ops.fwdlap import Jet
from deephall_tpu_torch.types import CheckpointState
from deephall_tpu_torch.weights import init_params

pytestmark = pytest.mark.cuda

# D = 32: the jet LayerNorm kernel takes D % 32 == 0.
RAW = {
    "system": {"nspins": [3, 0], "flux": 2},
    "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 16}},
}


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def random_walkers(seed, batch, nelec):
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (batch, nelec)))
    phi = rng.uniform(-np.pi, np.pi, (batch, nelec))
    return torch.from_numpy(np.stack([theta, phi], axis=-1).astype(np.float32))


def test_kfac_step_on_the_card_matches_the_cpu(device):
    # One KFAC step from the same parameters, walkers and zero curvature, the
    # local energy through the kernels on the card and through the plain
    # versions on the CPU: each leaf's update to 1e-3 of its largest update.
    cfg = config.Config.from_dict(RAW)
    cpu_model = make_network(cfg.system, cfg.network)
    init_params(cpu_model, torch.Generator().manual_seed(0))
    card_model = copy.deepcopy(cpu_model).to(device)
    data = random_walkers(1, 32, 3)
    before = {n: p.detach().clone() for n, p in cpu_model.named_parameters()}
    launches = jet_attention.attention_jet.launches, jet_layernorm.layernorm_jet.launches
    for model, x in ((cpu_model, data), (card_model, data.to(device))):
        init, step = optimizers.make_optimizer_step(cfg, model)
        step(CheckpointState(None, x, init(model, x), 0.1))
    torch.cuda.synchronize()
    assert jet_attention.attention_jet.launches == launches[0] + 1
    assert jet_layernorm.layernorm_jet.launches == launches[1] + 2
    card = dict(card_model.named_parameters())
    for name, p in cpu_model.named_parameters():
        want = (p.detach() - before[name]).double()
        got = (card[name].detach().cpu() - before[name]).double()
        err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
        assert err < 1e-3, (name, err)


def test_attention_kernels_follow_in_place_updates(device):
    # The optimizers write the attention weights in place; prepare_weights
    # must rebuild its split copies, and the kernels must then compute with
    # the new weights (2e-5 of each field's largest value, as the kernel tests).
    gen = torch.Generator(device=device).manual_seed(3)
    feat, heads, dh = 256, 4, 64

    def param(*shape, scale):
        return torch.nn.Parameter(torch.randn(shape, generator=gen, device=device) * scale)

    p = {n: {"kernel": param(feat, heads, dh, scale=1 / math.sqrt(feat)),
             "bias": param(heads, dh, scale=0.1)} for n in ("query", "key", "value")}
    p["out"] = {"kernel": param(heads, dh, feat, scale=1 / math.sqrt(feat)), "bias": param(feat, scale=0.1)}
    view = {n: {k: v.detach() for k, v in leaves.items()} for n, leaves in p.items()}
    x = Jet(*(torch.randn(shape, generator=gen, device=device)
              for shape in ((33, 6, feat), (15, 33, 6, feat), (33, 6, feat), (3, 33, 6, feat))))
    first = jet_attention.prepare_weights(view, heads)
    assert jet_attention.prepare_weights(view, heads) is first
    with torch.no_grad():
        for leaves in p.values():
            for v in leaves.values():
                v.sub_(0.05 * torch.randn(v.shape, generator=gen, device=device))
    assert jet_attention.prepare_weights(view, heads) is not first
    got = jet_attention.attention_jet(view, heads, x)
    want = jet_attention.attention_jet_plain(view, heads, x)
    for name, a, b in zip(Jet._fields, got, want):
        err = (a - b).abs().max().item() / b.abs().max().item()
        assert err <= 2e-5, (name, err)
