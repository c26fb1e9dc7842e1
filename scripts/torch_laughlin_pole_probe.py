#!/usr/bin/env python3
"""L^2 of the analytic Laughlin state (N=6, 2Q=15) near a pole, in float32 and float64.

    python3 scripts/torch_laughlin_pole_probe.py [--device cpu]

The Laughlin state is an L^2 = 0 eigenstate, so every walker's local L^2 is 0.
The full-Hessian path (``loss.batched_local_energy``) divides by powers of
sin(theta); for one electron at theta = pi - eps or eps it prints the local
L^2 and kinetic energy in both precisions, and the largest |L^2| over random
walkers.
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deephall_tpu_torch import loss  # noqa: E402
from deephall_tpu_torch.config import Config  # noqa: E402
from deephall_tpu_torch.networks import make_network  # noqa: E402

EPS = (1e-1, 3e-2, 1e-2, 3e-3, 1e-3, 3e-4, 1e-4)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--walkers", type=int, default=64)
    args = parser.parse_args()
    cfg = Config.from_dict({"system": {"nspins": [6, 0], "flux": 15},
                            "network": {"type": "laughlin"}})
    model = make_network(cfg.system, cfg.network).to(args.device)
    gen = torch.Generator().manual_seed(0)
    shape = (args.walkers, 6)
    theta = torch.arccos(2 * torch.rand(shape, generator=gen, dtype=torch.float64) - 1)
    phi = (torch.rand(shape, generator=gen, dtype=torch.float64) * 2 - 1) * math.pi
    for i, eps in enumerate(EPS):
        theta[i, 0] = math.pi - eps
        theta[len(EPS) + i, 0] = eps
    data = torch.stack([theta, phi], -1).to(args.device)
    local_energy = loss.batched_local_energy(model, cfg.system)
    with torch.no_grad():
        _, f32 = local_energy(data.float())
        _, f64 = local_energy(data)
    l2_32 = f32["angular_momentum_square"].double().cpu()
    l2_64 = f64["angular_momentum_square"].cpu()
    kinetic = f32["kinetic"].real.cpu()
    for i in range(2 * len(EPS)):
        print(f"theta_0 = {theta[i, 0].item():.6f}: L^2 float32 {l2_32[i].item():.4g}, "
              f"float64 {l2_64[i].item():.4g}; kinetic float32 {kinetic[i].item():.6f} (exact 3)")
    rest = slice(2 * len(EPS), None)
    print(f"other walkers: largest |L^2| float32 {l2_32[rest].abs().max().item():.4g}, "
          f"float64 {l2_64[rest].abs().max().item():.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
