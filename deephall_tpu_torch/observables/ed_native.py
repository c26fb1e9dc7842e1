"""Native (C++) Lanczos backend for the exact-diagonalization oracle.

A copy of ``deephall_tpu/observables/ed_native.py``: only the imports and the
cache directory of the compiled library differ (``build/deephall_tpu_torch/``
in the checkout, so that the two packages never share a library).

The dense path in :mod:`deephall_tpu_torch.observables.ed` caps out at a few
thousand basis states; the N=10 (2Q=27) and N=12 (2Q=23) production anchors
live in Lz=0 blocks of ~10^5 states, where only matrix-free Lanczos is
practical and each matvec performs ~10^8-10^9 candidate pair scatterings —
far beyond Python.  This module compiles ``_ed_native.cpp`` on demand with
the system ``g++`` (this image has no pip/pybind11; plain ctypes against a
C ABI, as the build environment prescribes), wraps it in a
``scipy.sparse.linalg.LinearOperator``, and drives ``eigsh``.

The native matvec is sign-convention-pinned against the pure-Python
``ed._apply_interaction`` in ``tests/test_ed_native.py`` (same ground
energies to 1e-10 on blocks the dense path can also solve).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).with_name("_ed_native.cpp")
_BUILD = Path(__file__).resolve().parents[2] / "build"


def _host_isa_tag() -> bytes:
    """Digest of the compiler's -march=native target on THIS host.

    The cache key must change across CPUs: a shared/persistent
    DEEPHALL_NATIVE_CACHE reused from a different machine would otherwise
    serve a .so compiled for another ISA and crash with SIGILL.
    """
    try:
        out = subprocess.run(
            ["g++", "-march=native", "-E", "-v", "-", "-o", os.devnull],
            input=b"",
            capture_output=True,
            timeout=30,
        )
        probe = out.stderr + out.stdout
    except Exception:
        probe = b""
    import platform

    return platform.machine().encode() + b"\0" + probe


def _build_library() -> Path:
    """Compile the kernel into a content-addressed cache path (once)."""
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + b"\0" + _host_isa_tag()).hexdigest()[:16]
    cache_dir = Path(os.environ.get("DEEPHALL_NATIVE_CACHE", _BUILD)) / "deephall_tpu_torch"
    cache_dir.mkdir(parents=True, exist_ok=True)
    lib_path = cache_dir / f"ed_native_{tag}.so"
    if lib_path.exists():
        return lib_path
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp.so")
    subprocess.run(
        [
            "g++",
            "-O3",
            "-march=native",
            "-shared",
            "-fPIC",
            "-o",
            str(tmp),
            str(_SRC),
        ],
        check=True,
        capture_output=True,
    )
    os.replace(tmp, lib_path)  # atomic under concurrent builds
    return lib_path


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(_build_library()))
        lib.ed_ctx_create.restype = ctypes.c_void_p
        lib.ed_ctx_create.argtypes = [
            ctypes.c_int,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint32),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.ed_ctx_free.argtypes = [ctypes.c_void_p]
        lib.ed_matvec.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
    return _lib


def lz_basis_masks(n_orb: int, nelec: int, two_lz: int) -> np.ndarray:
    """Occupation bitmasks of the ``sum 2m = two_lz`` block, ascending.

    A pruned depth-first enumeration (bounds on the achievable remaining
    ``sum 2m`` cut the search to ~block size), so the 13M-combination
    N=10, 2Q=27 space enumerates its ~10^5-state block in seconds instead of
    walking every combination like ``itertools`` would.
    """
    two_q = n_orb - 1
    two_ms = [2 * i - two_q for i in range(n_orb)]
    # suffix cumulative extremes: choosing r orbitals from index >= i
    masks: list[int] = []

    def rec(start: int, left: int, need: int, mask: int) -> None:
        if left == 0:
            if need == 0:
                masks.append(mask)
            return
        remaining = n_orb - start
        if remaining < left:
            return
        # max sum: take the 'left' largest available; min sum: the smallest
        hi = sum(two_ms[n_orb - left :]) if start <= n_orb - left else -(10**9)
        lo = sum(two_ms[start : start + left])
        if need > hi or need < lo:
            return
        rec(start + 1, left - 1, need - two_ms[start], mask | (1 << start))
        rec(start + 1, left, need, mask)

    rec(0, nelec, two_lz, 0)
    return np.asarray(sorted(masks), dtype=np.uint32)


class NativeBlock:
    """A (N, 2Q, Lz) block with a native matvec, usable as a LinearOperator."""

    def __init__(self, n_orb: int, masks: np.ndarray, v4: np.ndarray):
        if n_orb > 32:
            raise ValueError("native kernel packs occupations in 32 bits")
        self._lib = _load()
        self.masks = np.ascontiguousarray(masks, dtype=np.uint32)
        self.v4 = np.ascontiguousarray(v4, dtype=np.float64)
        self.dim = int(self.masks.shape[0])
        self._ctx = self._lib.ed_ctx_create(
            n_orb,
            self.dim,
            self.masks.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            self.v4.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )

    def __del__(self):
        if getattr(self, "_ctx", None):
            self._lib.ed_ctx_free(self._ctx)
            self._ctx = None

    def matvec(self, x: np.ndarray) -> np.ndarray:
        x = np.ascontiguousarray(x, dtype=np.float64).ravel()
        y = np.zeros(self.dim)
        self._lib.ed_matvec(
            self._ctx,
            x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            y.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        )
        return y


def ed_ground_lanczos(
    nelec: int,
    two_q: int,
    interaction: str = "coulomb",
    two_lz: int = 0,
    radius: float | None = None,
    num_states: int = 2,
    tol: float = 0.0,
    v4: np.ndarray | None = None,
):
    """Lowest eigenvalues of one Lz block via native matvec + Lanczos.

    Same result contract as :func:`ed.ed_block` (interaction-only energies,
    ground ``<L^2>``) for blocks far beyond the dense path.  The ``<L^2>`` of
    the ground vector is evaluated with the (one-shot, Python) ladder applier
    from :mod:`ed` — a single application is cheap even at 10^5 states.
    """
    from scipy.sparse.linalg import LinearOperator, eigsh

    from deephall_tpu_torch.observables import ed

    n_orb = two_q + 1
    if v4 is None:
        v4 = ed.pair_elements(two_q, interaction, radius)
    masks = lz_basis_masks(n_orb, nelec, two_lz)
    block = NativeBlock(n_orb, masks, v4)
    op = LinearOperator(
        (block.dim, block.dim), matvec=block.matvec, dtype=np.float64
    )
    k = min(num_states, block.dim - 1) if block.dim > 1 else 1
    if block.dim == 1:
        e0 = float(block.matvec(np.ones(1))[0])
        energies = np.array([e0])
        ground = np.ones(1)
    else:
        vals, vecs = eigsh(op, k=k, which="SA", tol=tol)
        order = np.argsort(vals)
        energies = vals[order]
        ground = vecs[:, order[0]]
    basis = [
        tuple(int(b) for b in np.flatnonzero((m >> np.arange(n_orb)) & 1))
        for m in masks
    ]
    l2 = float(ground @ ed._apply_total_l2(two_q, basis, ground))
    return ed.EDResult(
        energies=energies,
        ground_l2=l2,
        dim=block.dim,
        ground_state=ground,
        basis=basis,
    )
