#!/usr/bin/env python3
"""Batch means of a stored state's local observables through the port's jet.

    python3 scripts/torch_state_observables.py CHECKPOINT [--l2] [--walkers K]
        [--chunk 336] [--float64] [--device cpu]

Loads ``CHECKPOINT`` with the ``config.yml`` beside it, takes its first K
stored walkers (all by default) and evaluates the forward-Laplacian local
energy (``hamiltonian.forward_laplacian_local_energy``) in chunks: through
the kernels on the card, through the plain versions on the CPU, and through
the plain versions in float64 with ``--float64``.  ``--l2`` switches
``system.compute_l2`` on.  Prints one JSON line: each observable's mean over
the walkers, its standard error (walkers taken as independent) and its RMS,
with the device and, on the card, its name and power limit.  This is the
value of the state itself on its stored walkers, with no Metropolis moves:
the number an inference run's batch means scatter around.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
from pathlib import Path

import torch
import yaml

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("checkpoint", type=Path)
    parser.add_argument("--l2", action="store_true", help="compute L^2 (system.compute_l2)")
    parser.add_argument("--walkers", type=int, default=None, help="first K stored walkers")
    parser.add_argument("--chunk", type=int, default=336, help="walkers a call (default: 336)")
    parser.add_argument("--float64", action="store_true", help="the plain versions in float64")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)

    from deephall_tpu_torch import train  # noqa: F401  (switches TF32 off)
    from deephall_tpu_torch.config import Config
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.utils import resolve_device
    from deephall_tpu_torch.weights import load_flax

    device = resolve_device(args.device)
    cfg = Config.from_dict(yaml.safe_load((args.checkpoint.parent / "config.yml").read_text()))
    cfg.system.compute_l2 = args.l2
    _, state, _ = LogManager.restore_checkpoint(args.checkpoint)
    model = make_network(cfg.system, cfg.network)
    load_flax(model, state.params)
    dtype = torch.float64 if args.float64 else torch.float32
    model = model.to(device=device, dtype=dtype).requires_grad_(False)
    data = torch.as_tensor(state.data[: args.walkers], device=device, dtype=dtype)
    local_energy = forward_laplacian_local_energy(model, cfg.system,
                                                  kernels=device.type == "cuda" and not args.float64)
    values: dict[str, list] = {}
    with torch.no_grad():
        for chunk in data.split(args.chunk):
            el, obs = local_energy(chunk)
            for key, v in {"energy": el, **obs}.items():
                values.setdefault(key, []).append(v.real.double().cpu())
    report = {}
    for key, parts in values.items():
        v = torch.cat(parts)
        report[key] = dict(mean=v.mean().item(), sem=v.std().item() / math.sqrt(v.numel()),
                           rms=v.square().mean().sqrt().item())
    where = {"device": str(device)}
    if device.type == "cuda":
        where["nvidia_smi"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"checkpoint": str(args.checkpoint), "walkers": int(data.shape[0]),
                      "compute_l2": args.l2, "dtype": str(dtype), **where, "fields": report}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
