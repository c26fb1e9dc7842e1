"""Build and load the hand-written CUDA kernels of ``deephall_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc`` into
its own shared library ``build/deephall_tpu_torch/lib<name>_<hash>.so`` at first
use, then loaded with ``ctypes``.  All sources that need a build are compiled
at once, one ``nvcc`` process each.  The hash covers the source and the flags,
so an edited source is rebuilt.  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "deephall_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put it on PATH or set CUDA_HOME")
    return str(path)


def target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{digest.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every source whose library is missing or stale; return ``{name: path}``.

    The compiler's output (``-Xptxas=-v``: registers, shared memory, spills)
    is kept beside each library as ``<library>.log``.
    """
    sources = sorted(CSRC.glob("*.cu"))
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        out = target(src)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        jobs.append((src, out, tmp, proc))
    failures = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_name(out.name + ".log").write_text(log)
        if proc.returncode:
            failures.append(f"nvcc failed for {src.name}:\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return {src.stem: target(src) for src in sources}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built first if needed."""
    return ctypes.CDLL(str(build()[name]))


@functools.cache
def function(name: str, symbol: str, argtypes: tuple):
    """The C entry point ``symbol`` of library ``name``, returning an ``int`` (a
    CUDA status unless the entry point says otherwise).

    Pointers and the stream are ``ctypes.c_void_p``: an untyped argument would
    be passed as a 32-bit int and cut the pointer.
    """
    fn = getattr(library(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def require(v, device, shape, what: str) -> None:
    """Raise unless ``v`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if v.device != device or v.dtype != torch.float32:
        raise TypeError(f"{what}: need float32 on {device}, got {v.dtype} on {v.device}")
    if tuple(v.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(v.shape)} != {tuple(shape)}")
    if not v.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")


def stream(device) -> int:
    """The handle of PyTorch's current CUDA stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {status}")
