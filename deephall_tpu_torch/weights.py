"""Carry weights between the flax parameter tree and the port's modules.

A checkpoint (or JAX ``model.init``) holds ``{"params": {"PsiformerLayers_0":
{"Dense_0": {"kernel": array}}, ...}}``.  The port's modules carry the same
names and shapes, so the module state key is the tree path joined with dots.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def params_from_flax(tree: dict) -> dict[str, torch.Tensor]:
    """Module state (``{dotted.name: float32 tensor}``) from a flax parameter tree."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.float32, copy=True))
        for k, v in flatten(tree).items()
    }


def nest(named: dict) -> dict:
    """``{dotted.name: leaf}`` as a nested dict keyed by the name's parts."""
    tree: dict = {}
    for name, leaf in named.items():
        node = tree
        *path, last = name.split(".")
        for part in path:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, f"{prefix}{key}."))
        else:
            out[f"{prefix}{key}"] = value
    return out


def flatten(tree: dict) -> dict:
    """A flax tree (``{"params": {...}}`` or its inside) as ``{dotted.name: leaf}``."""
    return _flatten(tree["params"] if "params" in tree else tree)


def param_tree(module: nn.Module) -> dict:
    """Nested dict of the module's detached parameters, keyed by the flax names."""
    return nest({name: param.detach() for name, param in module.named_parameters()})


def to_flax(named: dict) -> dict:
    """``{dotted.name: tensor}`` (parameters, gradients, updates) as the flax tree
    ``{"params": {...}}`` of NumPy arrays."""
    return {"params": nest({k: v.detach().cpu().numpy().copy() for k, v in named.items()})}


def params_to_flax(module: nn.Module) -> dict:
    """The flax parameter tree ``{"params": {...}}`` of NumPy float32 arrays."""
    return to_flax({k: p.float() for k, p in module.named_parameters()})


def load_flax(module: nn.Module, tree: dict) -> None:
    """Copy a flax parameter tree into ``module``; names and shapes must match exactly."""
    state = params_from_flax(tree)
    own = dict(module.named_parameters())
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"parameter tree mismatch: missing {missing}, unexpected {unexpected}"
        )
    with torch.no_grad():
        for name, param in own.items():
            value = state[name]
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"{name}: checkpoint shape {tuple(value.shape)} != "
                    f"module shape {tuple(param.shape)}"
                )
            param.copy_(value)


def init_params(module: nn.Module, generator: torch.Generator) -> None:
    """Fresh parameters with flax's defaults: LeCun-normal kernels, zero biases.

    Kernels draw from a normal truncated at two standard deviations with variance
    ``1 / fan_in``, where ``fan_in = shape[-2] * prod(shape[:-2])`` as in
    ``flax.linen.initializers.lecun_normal``; LayerNorm scales and Jastrow
    parameters start at one.  The draws come from ``generator`` (a CPU generator).
    """
    with torch.no_grad():
        for name, param in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf == "kernel":
                shape = param.shape
                fan_in = shape[-2] * math.prod(shape[:-2])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                values = torch.empty(shape, dtype=torch.float32)
                nn.init.trunc_normal_(
                    values, std=std, a=-2 * std, b=2 * std, generator=generator
                )
                param.copy_(values)
            elif leaf in ("scale", "ee_par", "ee_anti"):
                param.fill_(1.0)
            else:
                param.zero_()
