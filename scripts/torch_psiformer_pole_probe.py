#!/usr/bin/env python3
"""The Psiformer's jet local energy with an electron near a pole (prod_r4, N=6, 2Q=15).

    python3 scripts/torch_psiformer_pole_probe.py [--device cpu]

It runs on the card unless ``--device cpu`` is given, and fails without one.

The sampler's float32 ``arccos`` puts an electron exactly on a pole, at
``float32(pi)``, or at least 3.45e-4 from one.  For the stored walkers of
``artifacts/prod_r4`` with electron 0 moved to such points
(:func:`pole_walkers`), and for ordinary stored walkers, this prints the
kinetic energy, E_L, L^2 and Lz of ``hamiltonian.forward_laplacian_local_energy``
in float32 (through the kernels) beside the plain route with the model and
the walkers in float64, and whether each walker is within :data:`GATE`.
``chip_smoke.py`` (phase ``psiformer_pole``) and
``tests/test_torch_psiformer_poles.py`` gate the port's values on them.
"""

from __future__ import annotations

import argparse
import copy
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy  # noqa: E402
from deephall_tpu_torch.utils import resolve_device  # noqa: E402

ARTIFACT = REPO / "artifacts" / "prod_r4"
# theta of electron 0 in the pole walkers, float32 as the sampler makes them;
# the last but one repeats pi - 1e-2 at another phi, the last is the pole itself.
POLE_THETA = (np.pi, np.pi - 3.4527e-4, np.pi - 1e-3, np.pi - 1e-2, 3.4527e-4, 1e-3, 1e-2,
              np.pi - 1e-2, 0.0)
OTHER_PHI = 1.234  # electron 0's phi in the repeated walker
# |float32 - float64| allowed at every pole walker (E_L is KE plus the potential).
GATE = {"kinetic": 2e-3, "energy": 2e-3, "angular_momentum_square": 5e-3,
        "angular_momentum_z": 1e-3}
KEYS = ("energy", "kinetic", "angular_momentum_z", "angular_momentum_z_square",
        "angular_momentum_square")


def prod_r4():
    """``(config, model on the CPU, stored walkers as numpy)`` of ``artifacts/prod_r4``."""
    import yaml

    from deephall_tpu_torch.config import Config
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.weights import load_flax

    cfg = Config.from_dict(yaml.safe_load((ARTIFACT / "config.yml").read_text()))
    _, state, _ = LogManager.restore_checkpoint(ARTIFACT / "ckpt_019999.npz")
    model = make_network(cfg.system, cfg.network)
    load_flax(model, state.params)
    return cfg, model.requires_grad_(False), np.asarray(state.data)


def pole_walkers(stored: np.ndarray, ordinary: int = 8) -> np.ndarray:
    """float32 ``[len(POLE_THETA) + ordinary, N, 2]``: stored walker ``i`` with
    electron 0 at ``theta = float32(POLE_THETA[i])`` (and ``phi = OTHER_PHI``
    in the repeated one), then ``ordinary`` stored walkers as they are."""
    n = len(POLE_THETA)
    data = np.array(stored[:n + ordinary], dtype=np.float32)
    data[:n, 0, 0] = np.float32(POLE_THETA)
    data[n - 2, 0, 1] = OTHER_PHI
    return data


def evaluate(model, system, data: torch.Tensor, kernels: bool) -> dict:
    """E_L and the observables of ``data``, each as float64 numpy (real parts)."""
    with torch.no_grad():
        el, obs = forward_laplacian_local_energy(model, system, kernels=kernels)(data)
    return {k: v.real.double().cpu().numpy() for k, v in {"energy": el, **obs}.items()}


def compare(model, system, data: torch.Tensor, kernels: bool = True) -> tuple[dict, dict]:
    """``data`` through ``model`` in float32 and through a float64 copy of it
    (plain route); returns both as :func:`evaluate` gives them."""
    model64 = copy.deepcopy(model).double()
    return (evaluate(model, system, data, kernels),
            evaluate(model64, system, data.double(), kernels=False))


def gate_failures(f32: dict, f64: dict, walkers: int = len(POLE_THETA)) -> list[str]:
    """The pole walkers (the first ``walkers``) off by more than :data:`GATE`,
    or not finite, as ``"key[i]: got vs want"``."""
    bad = []
    for key, tol in GATE.items():
        for i in range(walkers):
            got, want = f32[key][i], f64[key][i]
            if not (np.isfinite(got) and abs(got - want) <= tol):
                bad.append(f"{key}[{i}]: {got:.6g} vs {want:.6g}")
    return bad


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    cfg, model, stored = prod_r4()
    data = torch.from_numpy(pole_walkers(stored)).to(device)
    f32, f64 = compare(model.to(device), cfg.system, data)
    for i in range(data.shape[0]):
        line = "  ".join(f"{k} {f32[k][i]:.6g} ({f64[k][i]:.6g})" for k in KEYS)
        print(f"theta_0 = {data[i, 0, 0].item():.8f}: float32 (float64) {line}")
    bad = gate_failures(f32, f64)
    print("gate:", "every pole walker within" if not bad else bad, GATE)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
