#!/usr/bin/env python3
"""Time the jet local energy of a stored state's walkers on the card.

    python3 scripts/torch_local_energy_timing.py [--reps 5] [--ckpt CKPT [--config YML]]

By default the 3360 stored walkers of ``prod_r4``; ``--ckpt`` names another
checkpoint (``artifacts/prod_n10_r5/ckpt_027729.npz`` for N = 10) and
``--config`` its ``config.yml`` (by default the one beside the checkpoint).

It measures as ``chip_smoke.py``'s phase ``end_to_end`` does (its
``restored_model`` and ``cuda_ms``, imported from the ``chip_smoke.py`` of the
checkout that holds this script): the local energy through the hand-written
kernels and through the plain versions, and prints one JSON line with both
times, the launches of one call through the kernels and the card's name and
power limit.  Copied into another checkout (an older commit unpacked with
``git archive``), it times that checkout's package, so two commits can be
compared on one card in one call: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5, help="timed calls a route (default: 5)")
    parser.add_argument("--ckpt", type=Path, default=chip_smoke.GROUND_STATE,
                        help="checkpoint whose walkers are timed (default: prod_r4's)")
    parser.add_argument("--config", type=Path, default=None,
                        help="its config.yml (default: the one beside the checkpoint)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_local_energy_timing: no CUDA card", file=sys.stderr)
        return 1
    from deephall_tpu_torch import train  # noqa: F401  (switches TF32 off)
    from deephall_tpu_torch.hamiltonian import forward_laplacian_local_energy

    device = torch.device("cuda", 0)
    config = args.config or args.ckpt.resolve().parent / "config.yml"
    cfg, model, state = chip_smoke.restored_model(args.ckpt.resolve(), device, config.resolve())
    model.requires_grad_(False)
    data = torch.as_tensor(state.data, device=device)
    local_energy = {k: forward_laplacian_local_energy(model, cfg.system, kernels=k)
                    for k in (True, False)}
    with torch.no_grad():
        local_energy[True](data)
        torch.cuda.synchronize()
        chip_smoke.reset_counts()
        local_energy[True](data)
        torch.cuda.synchronize()
        launches = chip_smoke.launch_counts()
        times = {f"local_energy_{name}_ms": chip_smoke.cuda_ms(lambda k=k: local_energy[k](data),
                                                               reps=args.reps)
                 for name, k in (("kernels", True), ("plain", False))}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"checkout": str(REPO), "ckpt": str(args.ckpt), "nelec": int(data.shape[1]),
                      "walkers": int(data.shape[0]), **times,
                      "launches": launches, "nvidia_smi": smi}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
