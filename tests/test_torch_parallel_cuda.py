"""Walker data parallelism on a card: a one-rank NCCL group, two gloo ranks
on one card, the collectives on CUDA tensors, and the kernels on a shard.

These tests need an NVIDIA card with ``nvcc`` and skip elsewhere.  Run them on
the card with

    python -m pytest tests/test_torch_parallel_cuda.py -m cuda --noconftest
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from deephall_tpu_torch import parallel

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
LAUNCH_VARS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")

CHILD = """
import json, sys
import numpy as np, torch
sys.path.insert(0, {repo!r})
from deephall_tpu_torch import parallel, train  # train switches TF32 off
from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
from deephall_tpu_torch.log import LogManager
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.observables.runner import load_config
from deephall_tpu_torch.ops import jet_attention as ja, jet_layernorm as jl
from deephall_tpu_torch.weights import load_flax

device = parallel.initialize_distributed({device!r}, {backend!r}, timeout=120)
r, k = parallel.rank(), parallel.world_size()
x = torch.full((2, 3), float(r + 1), device=device)
z, c = parallel.all_reduce_sum(torch.tensor([1.0 + 2.0j * r], device=device),
                               torch.tensor([float(r), 1.0], device=device))
out = dict(
    rank=r, size=k, device=str(device),
    sum=parallel.all_reduce_sum(x).cpu().tolist(),
    packed=[[z.real.item(), z.imag.item()], c.cpu().tolist()],
    max=parallel.all_reduce_max(torch.tensor([float(r), -float(r)], device=device)).cpu().tolist(),
    gather=parallel.all_gather_rows(torch.arange(3.0, device=device)[:, None] + 10 * r).cpu().tolist(),
    gather_device=str(parallel.all_gather_rows(x).device),
)
y = torch.full((3,), float(r + 5), device=device)
parallel.broadcast_(y)
out["broadcast"] = y.cpu().tolist()
# The production Psiformer's local energy on this rank's shard of prod_r4's walkers.
ckpt = {ckpt!r}
cfg = load_config(ckpt)
_, state, _ = LogManager.restore_checkpoint(ckpt)
model = make_network(cfg.system, cfg.network)
load_flax(model, state.params)
model.to(device).requires_grad_(False)
data = parallel.shard_rows(torch.as_tensor(state.data)).to(device)
for fn in (jl.layernorm_jet, ja.attention_jet, ja.jet_gemm, ja.softmax_values):
    fn.launches = 0
ja.jet_gemm.launches_tensor_core = ja.softmax_values.launches_tiled = 0
jl.layernorm_jet.launches_streamed = jl.layernorm_jet.launches_staged = 0
with torch.no_grad():
    el, _ = forward_laplacian_local_energy(model, cfg.system)(data)
torch.cuda.synchronize()
out.update(
    walkers=int(data.shape[0]), finite=bool(torch.isfinite(el).all()),
    energy=parallel.all_reduce_mean(el.real.mean()).item(),
    launches=dict(layernorm=jl.layernorm_jet.launches, streamed=jl.layernorm_jet.launches_streamed,
                  staged=jl.layernorm_jet.launches_staged, gemm=ja.jet_gemm.launches,
                  tensor_core=ja.jet_gemm.launches_tensor_core,
                  softmax=ja.softmax_values.launches, tiled=ja.softmax_values.launches_tiled),
)
parallel.shutdown_distributed()
print(json.dumps(out))
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def run_ranks(tmp_path, ranks: int, device: str, backend: str) -> list[dict]:
    path = tmp_path / "child.py"
    path.write_text(CHILD.format(repo=str(REPO), device=device, backend=backend,
                                 ckpt=str(REPO / "artifacts/prod_r4/ckpt_019999.npz")))
    port = parallel.rendezvous_port()
    procs = []
    for rank in range(ranks):
        env = {k: v for k, v in os.environ.items() if k not in LAUNCH_VARS}
        env.update(RANK=str(rank), WORLD_SIZE=str(ranks), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, str(path)], env=env, text=True,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            assert p.returncode == 0, f"rc={p.returncode}\n{out}\n{err}"
            outs.append(json.loads(out.strip().splitlines()[-1]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def check_collectives(outs: list[dict]) -> None:
    size = len(outs)
    for r, got in enumerate(outs):
        assert (got["rank"], got["size"]) == (r, size)
        assert got["sum"] == [[size * (size + 1) / 2] * 3] * 2
        assert got["packed"] == [[size, size * (size - 1)], [size * (size - 1) / 2, size]]
        assert got["max"] == [size - 1.0, 0.0]
        assert got["gather"] == [[10.0 * q + i] for q in range(size) for i in range(3)]
        assert got["gather_device"] == got["device"]
        assert got["broadcast"] == [5.0] * 3


def check_kernels(outs: list[dict], walkers: int) -> None:
    # Every launch on a shard took the kernel built for the production shapes:
    # 2 layers, so 4 LayerNorms (streamed, none staged), 4 GEMMs (tensor
    # cores) and 2 softmax-values (tiled) per local energy.
    for got in outs:
        assert got["walkers"] == walkers and got["finite"]
        launches = got["launches"]
        assert launches == dict(layernorm=4, streamed=4, staged=0, gemm=4, tensor_core=4,
                                softmax=2, tiled=2), launches
    assert len({got["energy"] for got in outs}) == 1  # the global mean on every rank


def test_nccl_group_of_one(card, tmp_path):
    # WORLD_SIZE=1 through NCCL: every collective is a real call of one rank.
    outs = run_ranks(tmp_path, 1, "cuda", "nccl")
    check_collectives(outs)
    assert outs[0]["device"] == "cuda:0"
    check_kernels(outs, 3360)


def test_gloo_two_ranks_on_one_card(card, tmp_path):
    # Two ranks on card 0 through gloo (NCCL refuses two ranks on one card):
    # the collectives on CUDA tensors, and the kernels at a shard of 1680.
    outs = run_ranks(tmp_path, 2, "cuda:0", "gloo")
    check_collectives(outs)
    check_kernels(outs, 1680)


def test_nccl_one_card_per_rank(card, tmp_path):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards")
    outs = run_ranks(tmp_path, 2, "cuda", "nccl")
    assert [got["device"] for got in outs] == ["cuda:0", "cuda:1"]
    check_collectives(outs)
    check_kernels(outs, 1680)
