#!/usr/bin/env python3
"""Kinetic energy and L^2 of the analytic Laughlin state (N=6, 2Q=15) near a pole.

    python3 scripts/torch_laughlin_pole_probe.py [--device cpu]

It runs on the card unless ``--device cpu`` is given, and fails without one.

The Laughlin state is a lowest-Landau-level L^2 = 0 eigenstate, so every
walker's local kinetic energy is N Q / (2 R^2) = 3 and its local L^2 is 0.
Both divide by powers of sin(theta).  For one electron at theta = pi - eps or
eps, this prints them through the full-Hessian local energy in float32 (the
precision of the JAX package's evaluation) and through the port's
``loss.batched_local_energy`` (float64), and the largest deviations over the
other walkers.  :func:`pole_walkers` makes the walkers; ``chip_smoke.py`` and
``tests/test_torch_poles.py`` gate the port's values on them.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from deephall_tpu_torch import hamiltonian, loss  # noqa: E402
from deephall_tpu_torch.config import Config  # noqa: E402
from deephall_tpu_torch.networks import make_network  # noqa: E402
from deephall_tpu_torch.utils import resolve_device  # noqa: E402

POLE_EPS = (1e-3, 1e-4, 1e-5)  # the distances that the gates take
EPS = (1e-1, 1e-2, *POLE_EPS, 1e-6)
NELEC, FLUX, KINETIC = 6, 15, 3.0


def laughlin():
    """``(config, model)`` of the Laughlin state at N=6, 2Q=15 (on the CPU)."""
    cfg = Config.from_dict({"system": {"nspins": [NELEC, 0], "flux": FLUX},
                            "network": {"type": "laughlin"}})
    return cfg, make_network(cfg.system, cfg.network)


def pole_walkers(eps=POLE_EPS, walkers: int = 64, seed: int = 0) -> np.ndarray:
    """float32 ``[walkers, 6, 2]``, uniform on the sphere from a numpy seed,
    with electron 0 of walker ``i`` at theta = pi - ``eps[i]`` and of walker
    ``len(eps) + i`` at theta = ``eps[i]``."""
    rng = np.random.default_rng(seed)
    theta = np.arccos(rng.uniform(-1, 1, (walkers, NELEC)))
    phi = rng.uniform(-np.pi, np.pi, (walkers, NELEC))
    for i, e in enumerate(eps):
        theta[i, 0] = np.pi - e
        theta[len(eps) + i, 0] = e
    return np.stack([theta, phi], -1).astype(np.float32)


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    parser.add_argument("--walkers", type=int, default=64)
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg, model = laughlin()
    model = model.to(device)
    data = torch.from_numpy(pole_walkers(EPS, args.walkers)).to(device)
    float32 = torch.func.vmap(hamiltonian.local_energy(lambda x: model(x[None])[0], cfg.system))
    with torch.no_grad():
        _, f32 = float32(data)
        _, port = loss.batched_local_energy(model, cfg.system)(data)
    rows = {name: (obs["kinetic"].real.double().cpu(),
                   obs["angular_momentum_square"].double().cpu())
            for name, obs in (("float32", f32), ("port", port))}
    for i in range(2 * len(EPS)):
        line = ", ".join(f"{name}: kinetic {ke[i].item():.6f} L^2 {l2[i].item():.4g}"
                         for name, (ke, l2) in rows.items())
        print(f"theta_0 = {data[i, 0, 0].item():.8f}: {line}")
    rest = slice(2 * len(EPS), None)
    for name, (ke, l2) in rows.items():
        print(f"other walkers, {name}: largest |kinetic - 3| "
              f"{(ke[rest] - KINETIC).abs().max().item():.4g}, "
              f"largest |L^2| {l2[rest].abs().max().item():.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
