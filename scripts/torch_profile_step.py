"""Split one iteration of the port's production block into its parts, timed on the card.

The port's counterpart of ``scripts/profile_step.py``, with its flags and its
lines: the bf16 forward of the sweep, ``signed_logsumdet`` on ``[B, ndet, N,
N]``, the 10-move sweep, the local energy (the jet, with ``(C, E) = (15, 3)``
with L^2 and ``(13, 1)`` with ``--fast``), ``logsumdet_jet`` with ``--fast``,
the loss with its energy gradient, one KFAC training step and the iteration
inside a block of 10 (``scripts/torch_production_block.py``).  Beside them
the two parts of the training step that its split in ``chip_smoke.py``
names: the float32 forward in the KFAC capture with its two backward passes
(``loss.gradient_and_capture``) and the KFAC update (``kfac.kfac_update``).  Each part is
timed with CUDA events over calls in a row after a warm-up, and each line
also gives the launches of every hand-written kernel per call (the wrappers'
counters, ``deephall_tpu_torch.ops.launch_counts``).

    python3 scripts/torch_profile_step.py [--flux 15] [--nelec 6] [--batch 3360] [--fast]

It runs on the card unless ``--device cpu`` is given (for the tests; a CPU
time is the host's clock, no device number), and fails without a card.  The
last line is one JSON object.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

sys.path[:0] = [str(Path(__file__).resolve().parent), str(Path(__file__).resolve().parent.parent)]

BLOCK = 10
CALLS = 10  # timed calls of each part (half as many training steps)


def chain_time(fn, device: torch.device, calls: int = CALLS, warmup: int = 2) -> tuple[float, dict]:
    """(ms a call, kernel launches a call) over ``calls`` calls in a row after
    ``warmup``: CUDA events on the card, the host clock on the CPU."""
    from deephall_tpu_torch.ops import launch_counts

    for _ in range(warmup):
        fn()
    before = launch_counts()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / calls
    else:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        ms = (time.perf_counter() - t0) / calls * 1e3
    launches = {k: (v - before[k]) / calls for k, v in launch_counts().items()}
    return ms, launches


def profile(args, device: torch.device) -> list[dict]:
    """One row ``{part, label, ms, launches}`` per part; the block's row also
    has ``its_per_s`` and its launches are those of a whole block of 10."""
    from deephall_tpu_torch import loss, train
    from deephall_tpu_torch.loss import LossMode
    from deephall_tpu_torch.ops import fwdlap
    from deephall_tpu_torch.optimizers import kfac
    from deephall_tpu_torch.ops.slogdet import signed_logsumdet
    from deephall_tpu_torch.types import CheckpointState
    from torch_production_block import build_parts, initial_state

    parts = build_parts(not args.fast, BLOCK, device, nelec=args.nelec, flux=args.flux,
                        batch=args.batch)
    cfg, model, data, gen = parts.cfg, parts.model, parts.data, parts.generator
    width = torch.tensor(float(cfg.mcmc.width), device=device)
    ndet = cfg.network.psiformer.determinants
    rows = []

    def add(part: str, label: str, fn, n: int = CALLS, warmup: int = 2) -> dict:
        ms, launches = chain_time(fn, device, n, warmup)
        rows.append(dict(part=part, label=label, ms=ms, launches=launches))
        return rows[-1]

    with torch.no_grad():
        add("forward", f"forward (batch {args.batch})", lambda: model(data, train.sweep_dtype()))
        orb = torch.complex(
            *torch.randn((2, args.batch, ndet, args.nelec, args.nelec), generator=gen,
                         device=device))
        add("slogdet", f"slogdet (batch x {ndet} dets)", lambda: signed_logsumdet(orb))
        add("sweep", f"mcmc sweep ({cfg.mcmc.steps} moves)",
            lambda: parts.program.mcmc_step(data, width, gen))
        c, e = (2 * args.nelec + 1, 1) if args.fast else (2 * args.nelec + 3, 3)
        local_energy = loss.batched_local_energy(model, cfg.system)
        add("local_energy", f"local energy (jet, (C, E) = ({c}, {e}))", lambda: local_energy(data))
        if args.fast:
            # The determinant share of the jet: ``logsumdet_jet`` on orbital
            # jets of the production shapes, K + E = 2N + 1 channels and E = 1.
            shape = (args.batch, ndet, args.nelec, args.nelec)
            planes = torch.complex(*torch.randn((2, c + 3, *shape), generator=gen, device=device))
            jet = fwdlap.Jet(planes[0], planes[1:c + 1], planes[c + 1], planes[c + 2:])
            add("logsumdet_jet", "logsumdet_jet (det share)", lambda: fwdlap.logsumdet_jet(jet))
    grad_loss = loss.make_loss_fn(model, cfg.system, LossMode.ENERGY_GRAD)
    add("loss_gradient", "loss + energy gradient", lambda: grad_loss(data))

    # The training step's own parts, on this batch's local energy.
    with torch.no_grad():
        el, obs = local_energy(data)
    add("gradient_capture", "forward + two backward (KFAC capture)",
        lambda: loss.gradient_and_capture(model, cfg.system, data, el, obs))
    _, grads, inputs, dy = loss.gradient_and_capture(model, cfg.system, data, el, obs)
    specs = kfac.discover(model, args.nelec)
    # The update steps its parameters in place: it steps copies, so that the
    # parts timed after it start from the same model as before.
    params = {name: p.detach().clone() for name, p in model.named_parameters()}
    add("kfac_update", "KFAC update",
        lambda: kfac.kfac_update(cfg.optim.kfac, specs, params, parts.opt_state, grads, inputs, dy))
    del el, obs, grads, inputs, dy

    state = CheckpointState(model, data, parts.opt_state, width)

    def training_step():
        nonlocal state
        state, _ = parts.program.training_step(state)

    add("kfac_step", "full KFAC training step", training_step, n=CALLS // 2, warmup=1)

    block = parts.program.block
    carried = initial_state(parts)

    def run_block():
        nonlocal carried
        carried = block(*carried, BLOCK)[:3]

    row = add("block", f"fused iteration (block of {BLOCK})", run_block, n=1, warmup=1)
    row["block_ms"] = row["ms"]
    row["ms"] /= BLOCK
    row["its_per_s"] = 1e3 / row["ms"]
    return rows


def main(argv: list[str] | None = None) -> dict:
    from deephall_tpu_torch.utils import resolve_device

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--flux", type=int, default=15)
    parser.add_argument("--nelec", type=int, default=6)
    parser.add_argument("--batch", type=int, default=3360)
    parser.add_argument("--fast", action="store_true",
                        help="the jet without L^2 (system.compute_l2=false)")
    parser.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    args = parser.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        parser.error(str(e))
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (host clock)"
    print(f"device: {name}; N={args.nelec}, 2Q={args.flux}, batch {args.batch}, "
          f"{'lean' if args.fast else 'L^2'} mode")
    rows = profile(args, device)
    for row in rows:
        launches = {k: v for k, v in row["launches"].items() if v}
        extra = f"  ({row['its_per_s']:.2f} it/s)" if "its_per_s" in row else ""
        print(f"{row['label'] + ':':38s}{row['ms']:9.2f} ms{extra}  launches/call {launches or 0}")
    result = {"device": name, "mode": "lean" if args.fast else "l2", "batch": args.batch,
              "nelec": args.nelec, "flux": args.flux, "parts": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
