#!/usr/bin/env python3
"""Where the kernel path's and the plain path's training steps part, against float64.

    python3 scripts/torch_train_diagnostics.py

On one CUDA card: resumes ``artifacts/prod_r4`` under KFAC through the
training CLI for 10 iterations (as ``chip_smoke.py`` phase ``train`` does),
then, on the stored walkers and on the trained ones, evaluates the local
energy and its observables three ways: through the kernels (float32), through
the plain versions (float32) and through the plain versions in float64.  It
prints, per observable, each float32 path's batch-mean and median-walker error
against float64 and the kernel path's against the plain path's (relative to
the observable's RMS), the walkers where the two float32 paths part most, and
the relative L2 distance between the KFAC updates of one step taken with each
of the three local energies (same parameters, curvature, walkers and capture).
On the stored walkers it also takes the kernels one at a time, to say which
adds the kernel path's error: the jet LayerNorm kernel alone, the attention
kernels alone, and the attention kernels with the float32 CUDA-core
``jet_gemm`` in place of the tensor-core one.  One JSON line per state; the
last line is ``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
ARTIFACT = REPO / "artifacts/prod_r4/ckpt_019999.npz"
RESUME_STEP, ITERATIONS = 20000, 10
VARIANTS = ("layernorm_kernel_only", "attention_kernels_only", "attention_cuda_core_gemm")


@contextlib.contextmanager
def variant(name: str):
    """The kernel path with some kernels swapped for their plain versions."""
    from deephall_tpu_torch.ops import jet_attention as ja
    from deephall_tpu_torch.ops import jet_layernorm as jl

    saved = (jl.layernorm_jet, ja.attention_jet, ja.prepare_weights)
    prepare = ja.prepare_weights
    if name == "layernorm_kernel_only":
        ja.attention_jet = ja.attention_jet_plain
    elif name == "attention_kernels_only":
        jl.layernorm_jet = jl.layernorm_jet_plain
    elif name == "attention_cuda_core_gemm":
        jl.layernorm_jet = jl.layernorm_jet_plain
        ja.prepare_weights = lambda p, h: ja.AttentionWeights(
            *(v.w if isinstance(v, ja.SplitWeight) else v for v in prepare(p, h)))
    try:
        yield
    finally:
        jl.layernorm_jet, ja.attention_jet, ja.prepare_weights = saved


def local_energies(model, system, data, variants=()) -> dict:
    """``{path: (E_L, observables)}`` for the kernel, plain and float64 paths
    and the kernel ``variants``."""
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    model64 = copy.deepcopy(model).double()
    out = {}
    with torch.no_grad():
        for name, net, kernels, x in (("kernels", model, True, data),
                                      ("plain", model, False, data),
                                      ("float64", model64, False, data.double())):
            el, obs = forward_laplacian_local_energy(net, system, kernels=kernels)(x)
            out[name] = (el, obs)
        for name in variants:
            with variant(name):
                out[name] = forward_laplacian_local_energy(model, system)(data)
    return out


def observable_report(paths: dict) -> dict:
    report = {}
    fields = ["energy", *paths["float64"][1]]
    for key in fields:
        vals = {
            name: (el if key == "energy" else obs[key]).real.double()
            for name, (el, obs) in paths.items()
        }
        truth = vals["float64"]
        rms = truth.square().mean().sqrt().item()
        row = {"rms": rms}
        pairs = [(name, "float64") for name in paths if name != "float64"]
        for a, b in (*pairs, ("kernels", "plain")):
            dev = (vals[a] - vals[b]).abs()
            row[f"{a}_vs_{b}"] = dict(
                mean_shift_rel=abs(vals[a].mean().item() - vals[b].mean().item()) / rms,
                median_dev_rel=dev.median().item() / rms,
                max_abs=dev.max().item(),
            )
        report[key] = row
    # The walkers where the two float32 paths part most, in E_L and L^2.
    worst = {}
    for key in ("energy", "angular_momentum_square"):
        vals = {
            name: (el if key == "energy" else obs[key]).real.double()
            for name, (el, obs) in paths.items()
        }
        gap = (vals["kernels"] - vals["plain"]).abs()
        idx = torch.topk(gap, 5).indices.tolist()
        worst[key] = [
            dict(walker=i, float64=vals["float64"][i].item(),
                 kernels_err=(vals["kernels"][i] - vals["float64"][i]).item(),
                 plain_err=(vals["plain"][i] - vals["float64"][i]).item())
            for i in idx
        ]
    return {"fields": report, "worst_walkers": worst}


def update_report(cfg, model, data, opt_state, paths: dict) -> dict:
    """Relative L2 distances between one KFAC step's updates under each local energy."""
    from deephall_tpu_torch import loss
    from deephall_tpu_torch.optimizers import kfac

    paths = {k: paths[k] for k in ("kernels", "plain", "float64")}
    params = dict(model.named_parameters())
    saved = {k: p.detach().clone() for k, p in params.items()}
    specs = kfac.discover(model, sum(cfg.system.nspins))
    updates = {}
    for name, (el, obs) in paths.items():
        el = el.to(torch.complex64)
        obs = {k: v.to(torch.complex64 if v.is_complex() else torch.float32) for k, v in obs.items()}
        _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, data, el, obs)
        kfac.kfac_update(cfg.optim.kfac, specs, params, opt_state, grads, inputs, dy)
        updates[name] = {k: (p.detach() - saved[k]).double() for k, p in params.items()}
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(saved[k])

    def rel(a, b):
        num = sum(float((updates[a][k] - updates[b][k]).square().sum()) for k in saved)
        return math.sqrt(num / sum(float(updates[b][k].square().sum()) for k in saved))

    return {f"{a}_vs_{b}": rel(a, b) for a, b in
            (("kernels", "plain"), ("kernels", "float64"), ("plain", "float64"))}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_train_diagnostics: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import yaml

    from deephall_tpu_torch import optimizers, train
    from deephall_tpu_torch.config import Config
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.weights import load_flax

    device = torch.device("cuda", 0)
    cfg = Config.from_dict(yaml.safe_load((REPO / "artifacts/prod_r4/config.yml").read_text()))
    build = REPO / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as workdir:
        train.cli([
            "--yml", str(REPO / "artifacts/prod_r4/config.yml"), "optim.optimizer=kfac",
            f"log.restore_path={ARTIFACT}", f"log.save_path={workdir}",
            f"optim.iterations={RESUME_STEP + ITERATIONS}",
        ])
        trained = Path(workdir) / f"ckpt_{RESUME_STEP + ITERATIONS - 1:06d}.npz"
        for label, ckpt in (("stored", ARTIFACT), ("trained", trained)):
            _, state, _ = LogManager.restore_checkpoint(ckpt)
            model = make_network(cfg.system, cfg.network)
            load_flax(model, state.params)
            model.to(device)
            data = torch.as_tensor(state.data, device=device)
            variants = VARIANTS if label == "stored" else ()
            paths = local_energies(model, cfg.system, data, variants)
            opt_state = optimizers.state_to(state.opt_state, device)
            print(json.dumps(dict(state=label, walkers=int(data.shape[0]),
                                  **observable_report(paths),
                                  update_rel_l2=update_report(cfg, model, data, opt_state, paths))),
                  flush=True)
    name = torch.cuda.get_device_name(0)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
