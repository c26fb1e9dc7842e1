"""Structured configuration for the PyTorch port of deephall-tpu.

A copy of ``deephall_tpu/config.py``: the same schema, field for field, and the
same merge (structured defaults < YAML file < dotlist, with ``${a.b}``
interpolation), so CLI dotlists and ``config.yml`` sidecars parse identically in
both packages.  It is copied rather than imported because importing any module
of ``deephall_tpu`` imports JAX.  Keep the two files in step.
"""

from __future__ import annotations

import enum
import re
import time
import types
from dataclasses import dataclass, field, fields, is_dataclass
from typing import Any, Self, TypeVar, Union, get_args, get_origin, get_type_hints

import yaml

T = TypeVar("T")


class StrEnum(str, enum.Enum):
    """String-valued enum that serialises as its value."""

    def __str__(self) -> str:  # pragma: no cover - trivial
        return str(self.value)


def _convert_value(ftype: Any, value: Any) -> Any:
    """Coerce a plain YAML value into the declared field type."""
    if value is None:
        return None
    if is_dataclass(ftype):
        return from_dict(ftype, value)
    origin = get_origin(ftype)
    # PEP 604 unions (``float | None``) have origin types.UnionType, not typing.Union.
    if origin is Union or origin is types.UnionType:  # Optional[...]: try each member
        for arg in get_args(ftype):
            if arg is type(None):
                continue
            try:
                return _convert_value(arg, value)
            except (TypeError, ValueError):
                continue
        return value
    if origin is tuple:
        args = get_args(ftype)
        if len(args) == 2 and args[1] is Ellipsis:
            return tuple(_convert_value(args[0], v) for v in value)
        return tuple(_convert_value(a, v) for a, v in zip(args, value))
    if isinstance(ftype, type) and issubclass(ftype, enum.Enum):
        return ftype(value)
    if ftype is float:
        return float(value)
    if ftype is int and not isinstance(value, bool):
        return int(value)
    return value


def from_dict(cls: type[T], dikt: dict[str, Any]) -> T:
    """Restore a dataclass from a plain dictionary.

    Unknown keys are ignored for forward compatibility, matching the reference
    behaviour (``config.py:23-48``).

    Args:
        cls: Dataclass type to build.
        dikt: Dictionary of field values (possibly nested).

    Raises:
        ValueError: if the dictionary cannot be converted.

    Returns:
        An instance of ``cls``.
    """
    try:
        resolved = get_type_hints(cls)
        hints = {f.name: resolved[f.name] for f in fields(cls)}  # type: ignore[arg-type]
        kwargs = {}
        for key, value in dict(dikt).items():
            if key not in hints:
                continue  # allow extra keys
            kwargs[key] = _convert_value(hints[key], value)
        return cls(**kwargs)
    except Exception as e:  # noqa: BLE001
        raise ValueError(f"Error converting dictionary to {cls.__name__}: {e}") from e


def to_dict(obj: Any) -> Any:
    """Convert a (possibly nested) dataclass to plain YAML-safe containers."""
    if is_dataclass(obj):
        return {f.name: to_dict(getattr(obj, f.name)) for f in fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, (list, tuple)):
        return [to_dict(v) for v in obj]
    return obj


def to_yaml(obj: Any) -> str:
    """Render a config dataclass as YAML (same shape as OmegaConf.to_yaml)."""
    return yaml.safe_dump(to_dict(obj), sort_keys=False, default_flow_style=False)


def merge_dicts(base: dict, override: dict) -> dict:
    """Deep-merge ``override`` into ``base`` (override wins)."""
    out = dict(base)
    for key, value in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(value, dict):
            out[key] = merge_dicts(out[key], value)
        else:
            out[key] = value
    return out


_INTERP_RE = re.compile(r"\$\{([^${}]+)\}")


def resolve_interpolations(config: dict) -> dict:
    """Resolve OmegaConf-style ``${path.to.key}`` references in a plain dict tree.

    Reference configs go through ``OmegaConf.merge`` which supports value
    interpolation; this gives the
    plain-dict pipeline the same semantics for absolute-path interpolations: a
    string that is exactly ``${a.b}`` is replaced by the referenced value (any
    type), and ``${a.b}`` fragments inside a larger string are substituted
    textually. Chained references resolve transitively. Anything this cannot
    honour — unknown keys, reference cycles, or custom resolvers like
    ``${oc.env:...}`` — raises ``ValueError`` instead of passing the literal
    ``${...}`` string through to produce a silently different run.
    """

    def lookup(path: str, stack: tuple[str, ...]):
        path = path.strip()
        if ":" in path:
            raise ValueError(
                f"Unsupported OmegaConf resolver in interpolation '${{{path}}}': "
                "only plain ${path.to.key} references are supported."
            )
        if path in stack:
            chain = " -> ".join((*stack, path))
            raise ValueError(f"Interpolation cycle: {chain}")
        node: Any = config
        for part in path.split("."):
            if not isinstance(node, dict) or part not in node:
                raise ValueError(f"Interpolation '${{{path}}}': key not found")
            node = node[part]
        return resolve(node, (*stack, path))

    def resolve(value: Any, stack: tuple[str, ...]) -> Any:
        if isinstance(value, dict):
            return {k: resolve(v, stack) for k, v in value.items()}
        if isinstance(value, list):
            return [resolve(v, stack) for v in value]
        if isinstance(value, str) and "${" in value:
            full = _INTERP_RE.fullmatch(value)
            if full:
                return lookup(full.group(1), stack)
            out = _INTERP_RE.sub(lambda m: str(lookup(m.group(1), stack)), value)
            if "${" in out:
                raise ValueError(f"Malformed interpolation in {value!r}")
            return out
        return value

    return resolve(config, ())


def dotlist_to_dict(dotlist: list[str]) -> dict:
    """Parse ``path.to.key=value`` pairs into a nested dict (values YAML-parsed)."""
    result: dict[str, Any] = {}
    for item in dotlist:
        key, _, raw = item.partition("=")
        value = yaml.safe_load(raw) if raw != "" else None
        node = result
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return result


class InteractionType(StrEnum):
    coulomb = "coulomb"
    harmonic = "harmonic"


@dataclass
class System:
    flux: int = 2
    "Positive or negative integer $2Q$."

    radius: float | None = None
    r"By default, the radius of the sphere is fixed at $\sqrt{Q}$."

    nspins: tuple[int, int] = (3, 0)
    "Number of spin-up and spin-down electrons."

    interaction_strength: float = 1.0
    "The factor for the potential energy."

    lz_center: float = 0.0
    "Lz to pick using penalty method."

    lz_penalty: float = 0.0
    "The strength of the penalty for (Lz - lz_center)^2."

    l2_penalty: float = 0.0
    "The strength of the penalty for L^2."

    l2_center: float = 0.0
    """One-sided floor for the ``l2_penalty`` gradient: ``k * relu(<L^2> - c)``.

    TPU extension (the reference penalty is the ``c = 0`` special case, which
    is also the default here — for ``<L^2> >= 0`` the relu gate is always
    open at ``c = 0``).  With ``c = L(L+1)`` the penalty selects the ``L``
    multiplet *from above only*: inside an ``Lz = m`` sector every state has
    ``L >= m``, so for ``c = m(m+1)`` the gated penalty is identical to the
    linear selector ``k * <L^2>`` (extremal on eigenstates — the measured
    energy stays unbiased), while the cross-sector tunneling instability that
    bounded ``k < lz_penalty / 2m`` (a lower-L sector trades ``L^2`` saving
    against the ``Lz`` mismatch) gets zero gradient: below the floor the
    penalty vanishes, so the selector strength is no longer capped.  The gate
    reads the IQR-clipped batch mean, so a node-crossing walker cannot flip
    it.
    """

    l2_adaptive: bool = False
    """Deviation-proportional ``l2_penalty`` stiffness (selector annealing).

    TPU extension (no reference counterpart).  The constant one-sided selector
    has a measured stiffness dilemma on the hard magnetoroton sectors, where
    the targeted ``L = m`` member is NOT the lowest state of its ``Lz = m``
    window (at N=6 the roton minimum L=4 lies 0.050 below the L=2 member, so
    energy minimisation drifts UP the ``L^2`` ladder): the window-clamped
    gentle ``k`` cannot hold the state (sector 2 settle drifted
    ``<L^2>`` 7.8 -> 8.1 under k=0.2), while a stiff constant ``k`` rotates
    but dominates the KFAC geometry and the energy never converges (E = 7.78
    vs exact 7.0033 with variance 1.1 under k up to 2.25).  With
    ``l2_adaptive`` the effective stiffness self-anneals in-graph each step:

        k_eff = l2_penalty * clip(<L^2>_clipped - l2_center, 0, 1)
        lz_eff = max(lz_penalty, 3 * lz_center * k_eff)

    — full strength while the state is >= 1 above the target multiplet
    (purify regime), fading linearly to zero at the target (settle regime,
    where every penalty term vanishes on the converged eigenstate exactly, so
    the measured energy stays unbiased).  The ``lz_eff`` raise keeps the
    instantaneous stiffness inside the cross-sector tunneling window
    ``k < 0.8 lz / (2m)`` automatically (k_eff = lz_eff/(3m) < 0.4 lz_eff/m),
    decaying back to the nominal ``lz_penalty`` as the sector purifies.
    Requires ``compute_l2`` and a nonzero ``l2_center``/``lz_center`` to be
    meaningful; both statistics read IQR-clipped batch means, so a
    node-crossing walker cannot spike the stiffness.
    """

    orthogonal_states: tuple[str, ...] = ()
    """Checkpoint paths of converged lower states for excited-state VMC.

    TPU extension over the reference (its loss stops at the Lz/L^2 penalties):
    each path is loaded when the run starts (its ``config.yml`` sidecar must
    describe the same physical system) and the loss adds
    ``overlap_penalty * |<phi_j|psi>|^2 / (<phi_j|phi_j><psi|psi>)`` per state,
    estimated from the training walkers alone — see
    ``loss.orthogonality_stats_and_diff``.  Combined with ``lz_penalty`` /
    ``lz_center`` this targets the lowest state of an ``Lz`` sector that is
    orthogonal to already-found members, i.e. the magnetoroton branch.
    """

    overlap_penalty: float = 1.0
    """Strength of each ``orthogonal_states`` overlap penalty.

    Must exceed the energy gap to the target state, or the optimum keeps a
    component on the lower state; the per-step ``overlap`` statistic (sum over
    fixed states) should converge to ~0.
    """

    interaction_type: InteractionType = InteractionType.coulomb

    compute_l2: bool = True
    """Compute the L^2 observable each step.

    On the Psiformer training path both settings use the forward-Laplacian jet
    pipeline (no full Hessian anywhere): L^2 costs two extra jet directions
    per walker (the third coincides with the Lz one), not a Hessian. When False (and
    ``l2_penalty == 0``) those directions are dropped and ``L_square`` is
    logged as NaN; energy, Lz and Lz^2 are exact in both modes. The full
    Hessian survives only on the per-config protocol path
    (``hamiltonian.local_energy``) used by Laughlin inference and the netobs
    closures. The reference always computes L^2
    (``hamiltonian.py:139-159``), which is the default here too.
    """

    dynamic_penalties: bool = False
    """Pass the penalty scalars into the compiled step as runtime operands.

    TPU extension (no reference counterpart): with the default ``False`` the
    penalty values (``lz_center``, ``lz_penalty``, ``l2_penalty``,
    ``l2_center``, ``overlap_penalty``) are baked into the jitted training
    step as program
    constants — every new value is a fresh XLA compile (5-20 min on remote
    compile services).  ``True`` threads them through the fused iteration
    block as traced scalars instead, so sweeps over penalty values (e.g. the
    per-Lz-sector magnetoroton runs, ``scripts/magnetoroton.py``) share ONE
    compiled executable.  The penalty *terms* are then present in the graph
    unconditionally (a zero value multiplies them away at runtime); the
    ``l2_penalty`` term requires ``compute_l2=True`` in this mode.
    """


class NetworkType(StrEnum):
    psiformer = "psiformer"
    laughlin = "laughlin"


class OrbitalType(StrEnum):
    full = "full"
    sparse = "sparse"


@dataclass
class PsiformerNetwork:
    num_heads: int = 4
    heads_dim: int = 64
    num_layers: int = 2
    determinants: int = 1


@dataclass
class Network:
    type: NetworkType = NetworkType.psiformer
    orbital: OrbitalType = OrbitalType.full
    psiformer: PsiformerNetwork = field(default_factory=PsiformerNetwork)


@dataclass
class MCMC:
    steps: int = 10
    "MCMC steps to run between optimization steps."

    width: float = 0.1
    "The std dev for the Gaussian move proposal."

    burn_in: int = 200
    """MCMC burn-in steps to run before training.

    It's actually `mcmc.burn_in * mcmc.steps` number of steps.
    """

    adapt_frequency: int = 100
    "Number of steps after which to update the adaptive MCMC step size."


@dataclass
class LearningRate:
    """Learning rate with decay: rate * (1 / (1 + t/delay)) ** decay."""

    rate: float = 0.005
    decay: float = 1.0
    delay: float = 2000.0

    def schedule(self, t):
        return self.rate * (1.0 / (1.0 + (t / self.delay))) ** self.decay


class OptimizerName(StrEnum):
    adam = "adam"
    kfac = "kfac"
    none = "none"


@dataclass
class OptimizerAdam:
    lr: LearningRate = field(default_factory=LearningRate)


@dataclass
class OptimizerKfac:
    lr: LearningRate = field(default_factory=lambda: LearningRate(rate=0.05))
    damping: float = 1e-3
    curvature_ema: float = 0.95
    norm_constraint: float = 1e-3


@dataclass
class Optim:
    iterations: int = 1000
    optimizer: OptimizerName | None = OptimizerName.kfac
    adam: OptimizerAdam = field(default_factory=OptimizerAdam)
    kfac: OptimizerKfac = field(default_factory=OptimizerKfac)

    block_size: int = 1
    """Iterations fused into one device dispatch (``lax.scan``).

    TPU-native extension over the reference: with a remote/tunnelled runtime each
    dispatch + host readback costs tens of milliseconds, so production runs should
    set this to ~10.  Statistics are still logged per iteration (the scan stacks
    them); NaN-abort and checkpoint checks run once per block.
    """


@dataclass
class Log:
    save_path: str | None = None
    """Path to save checkpoints and logs (local or any fsspec URL)."""

    restore_path: str | None = None
    """Path to restore checkpoints: a directory of checkpoints or one file."""

    save_time_interval: int = 10 * 60
    """Minimum time (seconds) between checkpoint saves."""

    save_step_interval: int = 1000
    """Checkpoints are saved only at steps that are multiples of this value."""

    initial_energy: bool = True
    """Log initial energy before any optimization (debugging aid)."""

    profile_dir: str | None = None
    """If set, write a ``torch.profiler`` Chrome trace (``trace.json``) here.

    An addition over the reference (which has no tracing): the trace covers
    the blocks of steps [profile_start, profile_start + profile_steps), and
    names the port's layers as ``deephall.*`` ranges beside the device's
    kernels (:mod:`deephall_tpu_torch.tracing`).
    """

    profile_start: int = 10
    profile_steps: int = 5


@dataclass
class Config:
    batch_size: int = 3360  # 32*3*5*7 — divisible by many device counts
    seed: int = field(default_factory=lambda: int(time.time()))
    system: System = field(default_factory=System)
    network: Network = field(default_factory=Network)
    mcmc: MCMC = field(default_factory=MCMC)
    optim: Optim = field(default_factory=Optim)
    log: Log = field(default_factory=Log)

    @classmethod
    def from_dict(cls, dikt: dict) -> Self:
        """Convert a dictionary to Config."""
        return from_dict(cls, dikt)
