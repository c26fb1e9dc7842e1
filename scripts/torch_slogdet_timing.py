#!/usr/bin/env python3
"""The cost of a differentiable ``slogdet`` in the training step, on one CUDA card.

    python3 scripts/torch_slogdet_timing.py

Times ``loss.gradient_and_capture`` (the forward of log psi in the KFAC
capture and its two backward passes: ``forward_and_two_backward_ms`` of
``chip_smoke.py`` phase ``train``) on the 3360 stored walkers of
``artifacts/prod_r4`` with three versions of ``ops/slogdet.py:slogdet``:

- ``first_order``: the rule the port used before, ``c A^-H`` from the
  forward's LU outside the graph (first derivatives only);
- ``linalg``: ``torch.linalg.slogdet`` as it is;
- ``port``: the port's ``slogdet``, whose rules differentiate again.

Each is timed by CUDA events (median of 10 after 2 warm-up calls), in the
order first_order, port, linalg, linalg, port, first_order, twice, and each
one's parameter gradient is held against ``first_order``'s.  It also checks,
on the card, the second derivative of ``log|det A(x)|`` for five matrices under
``vmap(jacfwd(jacrev))`` through ``torch.linalg.slogdet`` and through the
port's ``slogdet`` against the same derivative taken one matrix at a time.
One JSON line; the card's name and power limit on the line before it.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]


class FirstOrderSlogdet(torch.autograd.Function):
    """``(sign, log|det a|)`` with the gradient ``c A^-H`` from the forward's LU."""

    @staticmethod
    def forward(ctx, a):
        from deephall_tpu_torch.ops.slogdet import _slogdet_from_lu

        lu, pivots, _ = torch.linalg.lu_factor_ex(a)
        sign, logabs = _slogdet_from_lu(lu, pivots)
        ctx.save_for_backward(lu, pivots, sign)
        return sign, logabs

    @staticmethod
    def backward(ctx, g_sign, g_logabs):
        lu, pivots, sign = ctx.saved_tensors
        eye = torch.eye(lu.shape[-1], dtype=lu.dtype, device=lu.device).expand(lu.shape)
        inv_h = torch.linalg.lu_solve(lu, pivots, eye, adjoint=True)
        c = g_logabs
        if lu.is_complex():
            c = torch.complex(g_logabs, (g_sign * sign.conj()).imag)
        return c[..., None, None] * inv_h


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def vmap_second_derivatives(fn, device) -> dict:
    """Largest relative distance between the batched and the one-at-a-time
    second derivative of ``log|det(A0 + x B + x^2 B^T)|`` at x = 0.3."""
    rng = np.random.default_rng(1)

    def draw():
        return torch.as_tensor(rng.standard_normal((5, 4, 4)) + 1j * rng.standard_normal((5, 4, 4)),
                               device=device)

    a0, b = draw(), draw()
    x0 = torch.tensor(0.3, dtype=torch.float64, device=device)

    def second(a0_i, b_i):
        return torch.func.jacfwd(torch.func.jacrev(lambda x: fn(a0_i + x * b_i + x**2 * b_i.mT)[1]))(x0)

    one = torch.stack([second(a0[i], b[i]) for i in range(5)])
    batched = torch.func.vmap(second)(a0, b)
    return {"max_rel_dev": ((batched - one).abs().max() / one.abs().max()).item(),
            "one_at_a_time": one.tolist()}


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_slogdet_timing: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import yaml

    from deephall_tpu_torch import hamiltonian, loss
    from deephall_tpu_torch import train  # noqa: F401  (switches TF32 off)
    from deephall_tpu_torch.config import Config
    from deephall_tpu_torch.log import LogManager
    from deephall_tpu_torch.networks import make_network
    from deephall_tpu_torch.ops import slogdet as sd
    from deephall_tpu_torch.weights import load_flax

    device = torch.device("cuda", 0)
    cfg = Config.from_dict(yaml.safe_load((REPO / "artifacts/prod_r4/config.yml").read_text()))
    _, state, _ = LogManager.restore_checkpoint(REPO / "artifacts/prod_r4/ckpt_019999.npz")
    model = make_network(cfg.system, cfg.network)
    load_flax(model, state.params)
    model.to(device)
    data = torch.as_tensor(state.data, device=device)
    with torch.no_grad():
        el, obs = hamiltonian.forward_laplacian_local_energy(model, cfg.system)(data)

    versions = {"first_order": FirstOrderSlogdet.apply, "linalg": torch.linalg.slogdet,
                "port": sd.slogdet}
    port = sd.slogdet
    times: dict = {name: [] for name in versions}
    grads = {}
    try:
        for name in 2 * ("first_order", "port", "linalg", "linalg", "port", "first_order"):
            sd.slogdet = versions[name]

            def step():
                return loss.gradient_and_capture(model, cfg.system, data, el, obs)

            times[name].append(cuda_ms(step))
            grads[name] = step()[1]
    finally:
        sd.slogdet = port
    ref = torch.cat([g.flatten() for g in grads["first_order"].values()])
    grad_dev = {name: ((torch.cat([x.flatten() for x in g.values()]) - ref).abs().max()
                       / ref.abs().max()).item() for name, g in grads.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(json.dumps({
        "torch": torch.__version__, "device": torch.cuda.get_device_name(0), "walkers": len(data),
        "forward_and_two_backward_ms": times,
        "gradient_max_rel_dev_from_first_order": grad_dev,
        "vmap_jacfwd_jacrev_second_derivative": {
            "linalg": vmap_second_derivatives(torch.linalg.slogdet, device),
            "port": vmap_second_derivatives(port, device),
        },
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
