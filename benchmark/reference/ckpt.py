"""A stored run read from its ``.npz`` with NumPy alone: parameters, walkers,
KFAC curvature and the sweep's width.

The checkpoint's ``params`` and ``opt_state`` are pickles.  Both are read by an
unpickler that builds NumPy arrays and builtin containers only; the KFAC
state's class (the JAX package's ``KfacState``, or the PyTorch port's tagged
dict) becomes :class:`Curvature` by its name, so nothing of either package is
imported.
"""

from __future__ import annotations

import io
import pickle
import zipfile
from typing import NamedTuple

import numpy as np


class Curvature(NamedTuple):
    """KFAC's stored state: ``kron {path: {a, g}}``, ``diag {path: {scale,
    bias}}``, the EMA normaliser ``weight`` and the step counter ``step``."""

    kron: dict
    diag: dict
    weight: np.ndarray
    step: np.ndarray


class _Unpickler(pickle.Unpickler):
    def find_class(self, module: str, name: str):
        if name == "KfacState":
            return Curvature
        if module == "numpy" or module.split(".")[0] in ("numpy", "builtins", "collections"):
            return super().find_class(module, name)
        raise pickle.UnpicklingError(f"refusing to unpickle {module}.{name}")


def _read_object(zf: zipfile.ZipFile, key: str):
    with zf.open(f"{key}.npy") as fp:
        version = np.lib.format.read_magic(fp)
        if version == (1, 0):
            np.lib.format.read_array_header_1_0(fp)
        else:
            np.lib.format.read_array_header_2_0(fp)
        arr = _Unpickler(io.BytesIO(fp.read())).load()
    return arr.tolist() if isinstance(arr, np.ndarray) else arr


def flatten(tree: dict, prefix: str = "") -> dict:
    """A nested parameter tree as ``{dotted.name: array}``."""
    if "params" in tree and not prefix:
        tree = tree["params"]
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


class Stored(NamedTuple):
    params: dict  # {dotted.name: float32 array}
    data: np.ndarray  # [batch, nelec, 2]
    curvature: Curvature | None
    mcmc_width: float


def load(path) -> Stored:
    with open(path, "rb") as f:
        blob = f.read()
    with zipfile.ZipFile(io.BytesIO(blob)) as zf:
        params = flatten(_read_object(zf, "params"))
        state = _read_object(zf, "opt_state")
    if isinstance(state, dict) and state.get("optimizer") == "kfac":
        state = Curvature(**{k: state[k] for k in Curvature._fields})
    with np.load(io.BytesIO(blob), allow_pickle=False) as f:
        data = np.asarray(f["data"]).reshape(-1, *f["data"].shape[-2:])
        width = float(np.asarray(f["mcmc_width"]).reshape(()))
    return Stored(params, data, state if isinstance(state, Curvature) else None, width)
