"""KFAC (port of ``deephall_tpu/optimizers/kfac.py``).

The curvature model of the JAX package, block by block:

* **Kronecker blocks** ``F_l ~= T * A (x) G`` for every ``Dense`` and
  ``DenseGeneral``: ``A = a^T a / rows`` of the layer inputs (a ones column
  appended when the layer has a bias), ``G = g^T g / rows`` of the exact-Fisher
  output sensitivities, real parts of complex layers only, ``T`` the rows one
  walker contributes (found by a forward of one configuration);
* **diagonal blocks** for the LayerNorm scale and bias: per-walker sums of
  ``g * x_hat`` and of ``g``, then the mean of their squares;
* **identity blocks** (``g / damping``) for every other parameter (the Jastrow
  cusps).

Factors are EMA'd from zeros with the ``weight`` normaliser.  The update solves
``(sqrt(T) A + pi_A I) dW (sqrt(T) G + pi_G I) = grad`` per layer with
pi-split damping, takes the learning rate at the step before the increment,
and scales the step by ``min(1, sqrt(c / (lr^2 d^T F d)))``, the norm
constraint.  Each Kronecker factor is a Gram product,
``ops/kfac_gram.py:gram`` (the hand-written kernel on the card, the bias's
ones column taken inside it), counted as ``kfac.factors`` in the open block
record; the solves are ``torch.linalg.solve_ex``.  Parameters are updated in
place, and nothing is read back to the host.  The orbital head's blocks
(``Orbitals_0``) are factored and solved in the span ``orbital_factors``, once
in each of :func:`factor_update` and :func:`precondition`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from deephall_tpu_torch import parallel, tracing
from deephall_tpu_torch.config import OptimizerKfac
from deephall_tpu_torch.networks.blocks import LayerNorm, kfac_capture
from deephall_tpu_torch.ops.kfac_gram import gram
from deephall_tpu_torch.types import CheckpointState, KfacState


class LayerSpec(NamedTuple):
    path: str  # module path joined with "/", the KfacState key
    name: str  # the same path joined with ".", the parameter-name prefix
    kind: str  # "kron" | "diag"
    has_bias: bool
    fan_in: int
    fan_out: int
    repeats: int  # rows one walker contributes (fixed_scale T)


def discover(model, nelec: int) -> list[LayerSpec]:
    """The recorded layers and their repeat counts, from one configuration."""
    device = next(model.parameters()).device
    with torch.no_grad(), kfac_capture(model) as capture:
        model(torch.zeros((1, nelec, 2), device=device))
    modules = dict(model.named_modules())
    specs = []
    for path, y2d in capture.outputs.items():
        name = path.replace("/", ".")
        module = modules[name]
        fan_in = capture.inputs[path].shape[-1]
        if isinstance(module, LayerNorm):
            specs.append(LayerSpec(path, name, "diag", True, fan_in, y2d.shape[-1], y2d.shape[0]))
        else:
            specs.append(LayerSpec(path, name, "kron", module.bias is not None, fan_in,
                                   y2d.shape[-1], y2d.shape[0]))
    return specs


def _head_in_span(specs: list[LayerSpec]):
    """``specs`` in their order; from the first of the orbital head's blocks
    (``Orbitals_0``), which ``discover`` puts last, the loop's body runs
    inside the span ``orbital_factors``."""
    head = next((i for i, spec in enumerate(specs) if spec.path.startswith("Orbitals_0/")), len(specs))
    assert all(spec.path.startswith("Orbitals_0/") for spec in specs[head:]), "the head's blocks come last"
    yield from specs[:head]
    if head < len(specs):
        with tracing.span("orbital_factors"):
            yield from specs[head:]


def _factor(x: torch.Tensor, ones_column: bool = False) -> torch.Tensor:
    """The Kronecker factor ``[x 1]^T [x 1] / rows``, counted as ``kfac.factors``."""
    tracing.count("kfac.factors")
    return gram(x, ones_column)


def factor_update(specs: list[LayerSpec], inputs: dict, dy: dict) -> tuple[dict, dict]:
    """One step's curvature blocks from the captured inputs and sensitivities.

    Every block is a mean over walkers; over several ranks each rank's means
    over its shard are averaged in one collective, so that every rank holds
    the moments of the whole batch and solves the same damped systems.
    """
    kron, diag = {}, {}
    for spec in _head_in_span(specs):
        a, g = inputs[spec.path], dy[spec.path]
        a = a.real if a.is_complex() else a
        g = g.real if g.is_complex() else g
        if spec.kind == "kron":
            kron[spec.path] = {"a": _factor(a, spec.has_bias), "g": _factor(g)}
        else:
            a3 = a.reshape(-1, spec.repeats, a.shape[-1])
            g3 = g.reshape(-1, spec.repeats, g.shape[-1])
            g_scale = torch.sum(g3 * a3, dim=1)  # [B, f]
            g_bias = torch.sum(g3, dim=1)
            diag[spec.path] = {
                "scale": torch.mean(g_scale**2, dim=0),
                "bias": torch.mean(g_bias**2, dim=0),
            }
    # Every block has two leaves, so the collective returns a tuple.
    leaves = [(block, leaf) for blocks in (kron, diag) for block in blocks.values()
              for leaf in block]
    means = parallel.all_reduce_mean(*(block[leaf] for block, leaf in leaves))
    for (block, leaf), value in zip(leaves, means):
        block[leaf] = value
    return kron, diag


def precondition(specs: list[LayerSpec], state: KfacState, grads: dict, damping: float):
    """Solve the damped blockwise system: ``({name: update}, d^T F d)``."""
    updates = {}
    quad = torch.zeros((), device=state.weight.device)
    weight = torch.clamp(state.weight, min=1e-8)
    for spec in _head_in_span(specs):
        if spec.kind == "kron":
            scale = math.sqrt(float(spec.repeats))
            a_mat = state.kron[spec.path]["a"] / weight * scale
            g_mat = state.kron[spec.path]["g"] / weight * scale
            dim_a, dim_g = a_mat.shape[0], g_mat.shape[0]
            tr_a = torch.trace(a_mat) / dim_a
            tr_g = torch.trace(g_mat) / dim_g
            pi = torch.sqrt(torch.clamp(tr_a, min=1e-20) / torch.clamp(tr_g, min=1e-20))
            a_damped = a_mat + math.sqrt(damping) * pi * torch.eye(dim_a, device=a_mat.device)
            g_damped = g_mat + math.sqrt(damping) / pi * torch.eye(dim_g, device=g_mat.device)
            kernel = grads[f"{spec.name}.kernel"]
            gmat = kernel.reshape(-1, dim_g)
            if spec.has_bias:
                gmat = torch.cat([gmat, grads[f"{spec.name}.bias"].reshape(1, dim_g)], dim=0)
            # A^-1 g G^-1; solve_ex leaves its info on the device, as
            # jnp.linalg.solve has none: the host does not wait for it.
            delta = torch.linalg.solve_ex(a_damped, gmat).result
            delta = torch.linalg.solve_ex(g_damped, delta.T).result.T
            quad = quad + torch.sum(delta * (a_damped @ delta @ g_damped))
            if spec.has_bias:
                updates[f"{spec.name}.bias"] = delta[-1].reshape(grads[f"{spec.name}.bias"].shape)
                delta = delta[:-1]
            updates[f"{spec.name}.kernel"] = delta.reshape(kernel.shape)
        else:
            for leaf in ("scale", "bias"):
                d = state.diag[spec.path][leaf] / weight + damping
                delta = grads[f"{spec.name}.{leaf}"] / d
                quad = quad + torch.sum(delta * d * delta)
                updates[f"{spec.name}.{leaf}"] = delta
    for name, g in grads.items():
        if name not in updates:  # identity block (the Jastrow cusps)
            delta = g / damping
            quad = quad + torch.sum(delta * damping * delta)
            updates[name] = delta
    return updates, quad


def kfac_update(optim_cfg: OptimizerKfac, specs: list[LayerSpec], params: dict,
                opt_state: KfacState, grads: dict, inputs: dict, dy: dict):
    """Fold one step's curvature into the EMA, precondition and apply the step.

    Updates ``params`` in place; returns the new state and
    ``{"learning_rate", "norm_coefficient", "quadratic_norm"}``.
    """
    ema = optim_cfg.curvature_ema
    with torch.no_grad():
        kron_new, diag_new = factor_update(specs, inputs, dy)
        new_state = KfacState(
            kron={k: {f: ema * v + (1 - ema) * kron_new[k][f] for f, v in block.items()}
                  for k, block in opt_state.kron.items()},
            diag={k: {f: ema * v + (1 - ema) * diag_new[k][f] for f, v in block.items()}
                  for k, block in opt_state.diag.items()},
            weight=ema * opt_state.weight + (1 - ema),
            step=opt_state.step + 1,
        )
        deltas, quad = precondition(specs, new_state, grads, optim_cfg.damping)
        lr = optim_cfg.lr.schedule(opt_state.step)
        coeff = torch.clamp(
            torch.sqrt(optim_cfg.norm_constraint / torch.clamp(lr**2 * quad, min=1e-20)), max=1.0
        )
        for name, p in params.items():
            p.sub_(lr * coeff * deltas[name])
    return new_state, {"learning_rate": lr, "norm_coefficient": coeff, "quadratic_norm": quad}


def make_kfac_training_step(optim_cfg: OptimizerKfac, capture_fn, model, nelec: int):
    """``(init, step)``; ``capture_fn(data, penalties) -> (stats, grads, inputs, dy)``
    (``loss.make_loss_and_capture_fn``).  The step's statistics carry the
    learning rate, the norm-constraint coefficient and ``d^T F d`` besides.
    The update is the span ``update`` (:mod:`deephall_tpu_torch.tracing`)."""
    params = dict(model.named_parameters())
    specs: list[LayerSpec] = []

    def layer_specs() -> list[LayerSpec]:
        if not specs:
            specs.extend(discover(model, nelec))
        return specs

    def init(model, data) -> KfacState:
        del data
        device = next(model.parameters()).device

        def zeros(*shape):
            return torch.zeros(shape, device=device)

        kron, diag = {}, {}
        for spec in layer_specs():
            if spec.kind == "kron":
                fan_in = spec.fan_in + int(spec.has_bias)
                kron[spec.path] = {"a": zeros(fan_in, fan_in), "g": zeros(spec.fan_out, spec.fan_out)}
            else:
                diag[spec.path] = {"scale": zeros(spec.fan_out), "bias": zeros(spec.fan_out)}
        return KfacState(kron, diag, zeros(), torch.zeros((), dtype=torch.int32, device=device))

    def step(state: CheckpointState, penalties: dict | None = None):
        stats, grads, inputs, dy = (
            capture_fn(state.data, penalties) if penalties else capture_fn(state.data))
        with tracing.span("update"):
            opt_state, info = kfac_update(optim_cfg, layer_specs(), params, state.opt_state,
                                          grads, inputs, dy)
        return state._replace(opt_state=opt_state), {**stats, **info}

    return init, step
