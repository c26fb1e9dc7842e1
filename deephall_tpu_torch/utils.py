"""Device selection and precision settings shared by the entry points."""

from __future__ import annotations

import functools

import torch


def set_full_precision() -> None:
    """Forbid TF32 in float32 matrix products and convolutions.

    Local energies are second derivatives of the network; reduced-precision
    products shift the energy measurably, so everything that feeds them runs in
    full float32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on; raises if CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU."
        )
    return device


@functools.cache
def constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The tensor of ``values`` on ``device``, made once and shared (read only).

    Each entry is written by a fill on the device: a tensor copied from the
    host would make the host wait for the card's queue.  It is made outside
    any ``torch.func`` transform, even when the first call comes from inside
    one (the full-Hessian local energy): a tensor made in a transform is
    wrapped for it and may not be used after it.
    """
    with torch._C._DisableFuncTorch():
        out = torch.empty(len(values), dtype=dtype, device=device)
        for i, value in enumerate(values):
            out[i].fill_(value)
    return out
