"""Operations and bytes of aten operations, counted from their shapes on the CPU.

A copy of the counter of ``scripts/torch_flops_count.py`` (its rules, its
``OpCounter`` dispatch mode, the carry of an affine count to the production
batch and the least times at the H100's peaks), frozen here so that a change
to the program cannot change the yardstick.  :mod:`benchmark.work.count`
drives it over a cell's iteration block and stores the result beside the
configuration.

The conventions are XLA's ``HloCostAnalysis``: a product ``2 m n k`` (complex
``8 m n k``), elementwise 1 per output element, a reduction 1 per input
element, transcendentals apart, LAPACK's counts for LU, solves and inverses,
bytes as every operand read once and every result written once, unfused.
An operation with no rule raises :class:`UncountedOp`.
"""

from __future__ import annotations

import collections
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

CLASSES = ("bf16 products", "float32 products", "other float32", "complex")
# Peak rates of one NVIDIA H100 SXM at 700 W (NVIDIA's data sheet, dense): the
# float32 products as three TF32 products on the tensor cores, which is how
# the port's GEMM keeps float32 accuracy; transcendentals at the float32 rate.
PEAK_FLOPS = {"bf16 products": 989e12, "float32 products": 495e12 / 3,
              "other float32": 67e12, "complex": 67e12}
MEMORY_RATE = 3.35e12
# Walker counts the block is counted at; the production batch must be an
# integer number of their difference past the first.
COUNT_BATCHES = (16, 32, 48)
PRODUCTION_BATCH = 3360


class UncountedOp(RuntimeError):
    """An aten operation that :class:`OpCounter` has no rule for."""


class Count:
    """Operations by class, transcendentals, bytes, and the sorts kept apart
    as ``(rows, length)`` (their count is not affine in the length)."""

    def __init__(self):
        self.flops: collections.Counter = collections.Counter()
        self.transcendentals = 0
        self.bytes = 0
        self.sorts: list[tuple[int, int]] = []

    def affine(self) -> dict:
        return {**{c: self.flops[c] for c in CLASSES}, "transcendentals": self.transcendentals,
                "bytes": self.bytes}


# --- the rules --------------------------------------------------------------------

VIEWS = {
    "view", "_unsafe_view", "_reshape_alias", "reshape", "permute", "transpose", "t", "select",
    "slice", "unsqueeze", "squeeze", "squeeze_", "unsqueeze_", "expand", "diagonal", "alias",
    "detach", "split", "split_with_sizes", "unbind", "view_as_real", "view_as_complex",
    "_conj", "conj", "_neg_view", "real", "imag", "as_strided", "lift_fresh", "promote_types",
    "movedim", "narrow", "unfold", "t_", "transpose_",
}
# Data movement: bytes, no arithmetic.  (An in-place ``name_`` takes the rule
# of ``name`` throughout.)
MOVES = {
    "clone", "copy", "contiguous", "cat", "stack", "index", "_unsafe_index", "gather",
    "index_select", "take_along_dim", "masked_select", "scatter", "index_copy", "index_put",
    "select_backward", "slice_backward", "diagonal_backward", "expand_backward", "slice_scatter",
    "select_scatter", "diagonal_scatter", "as_strided_scatter", "fill", "zero", "fill_diagonal",
    "zeros", "zeros_like", "ones", "ones_like", "full", "full_like", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "new_zeros", "new_ones", "new_full",
    "arange", "eye", "scalar_tensor", "lift", "rand", "randn", "rand_like", "randn_like",
    "normal", "uniform", "bernoulli", "random", "exponential", "repeat", "constant_pad_nd",
    "flip", "roll", "diag_embed", "complex", "resolve_conj", "resolve_neg",
    "_local_scalar_dense",
}
ELEMENTWISE = {
    "add", "sub", "rsub", "mul", "div", "neg", "abs", "sign", "sgn", "square", "reciprocal",
    "clamp", "clamp_min", "clamp_max", "maximum", "minimum", "relu", "threshold_backward",
    "ceil", "floor", "round", "trunc", "frac", "remainder", "fmod", "copysign", "hypot",
    "eq", "ne", "lt", "le", "gt", "ge", "isnan", "isinf", "isfinite", "isposinf", "isneginf",
    "signbit", "logical_and", "logical_or", "logical_xor", "logical_not", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "where", "masked_fill", "triu", "tril",
}
# Arithmetic per output element of the elementwise operations that do more than one.
ELEMENTWISE_WORK = {"lerp": 3, "addcmul": 3, "addcdiv": 3, "nan_to_num": 3,
                    "tanh_backward": 3, "sigmoid_backward": 3, "polar": 2}
TRANSCENDENTAL = {"exp", "log", "sqrt", "rsqrt", "tanh", "sin", "cos", "tan", "acos", "asin",
                  "atan", "atan2", "sigmoid", "erf", "expm1", "log1p", "polar", "log2", "exp2",
                  "log10", "sinh", "cosh", "asinh", "acosh", "atanh", "angle"}
# Transcendentals per element beyond 1 (polar is a cosine and a sine).
TRANSCENDENTAL_WORK = {"polar": 2}
# Complex elementwise arithmetic in real operations, by output element (a
# multiply or divide of two complex operands; with a real one it is 2).
COMPLEX_WORK = {"mul": 6, "div": 11, "reciprocal": 5, "abs": 3, "exp": 2, "log": 4,
                "nan_to_num": 6}
COMPLEX_TRANSCENDENTALS = {"exp": 3, "log": 2, "abs": 1}
REDUCTIONS = {"sum", "nansum", "mean", "amax", "amin", "max", "min", "prod", "any", "all",
              "argmax", "argmin", "trace", "cumsum", "cumprod", "aminmax", "count_nonzero",
              "equal"}
PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "dot", "vdot", "mv", "addmv"}


def getrf(n: int) -> tuple[int, int]:
    """LU of an ``n x n`` matrix with partial pivoting (LAWN 41, ``xGETRF``,
    m = n): (multiplications, additions)."""
    return (n**3 + 2 * n) // 3, (2 * n**3 - 3 * n**2 + n) // 6


def getrs(n: int, nrhs: int) -> tuple[int, int]:
    """Two triangular solves of ``nrhs`` columns on an LU (``xGETRS``)."""
    return n * n * nrhs, n * n * nrhs - n * nrhs


def getri(n: int) -> tuple[int, int]:
    """The inverse from an LU (``xGETRI``)."""
    return (4 * n**3 + 3 * n**2 + 5 * n) // 6, (4 * n**3 - 9 * n**2 + 5 * n) // 6


def lapack_flops(counts, complex_: bool, batch: int) -> int:
    """Real operations of ``batch`` solves with (multiplications, additions)
    ``counts``: a complex multiply is 6 real operations, a complex add 2."""
    mults, adds = (sum(c) for c in zip(*counts))
    return batch * (6 * mults + 2 * adds if complex_ else mults + adds)


def _tensors(tree) -> list[torch.Tensor]:
    return [v for v in tree_leaves(tree) if isinstance(v, torch.Tensor)]


def _is_complex(tensors) -> bool:
    return any(v.is_complex() for v in tensors)


def _batch(t: torch.Tensor, matrix_dims: int = 2) -> int:
    return math.prod(t.shape[:-matrix_dims])


def product_flops(name: str, args, out: torch.Tensor, real_factors: int = 0) -> int:
    """``2 m n k`` of a real product, and the addition of ``addmm``'s and
    ``baddbmm``'s first operand.  A complex product is ``8 m n k``; with
    ``real_factors`` of its two factors complex casts of real tensors it is
    two real products (``4 m n k``), or one: the cast adds zeros that no
    implementation has to multiply."""
    a = args[1] if name in ("addmm", "baddbmm", "addmv") else args[0]
    fma = out.numel() * a.shape[-1]
    flops = ((8, 4, 2)[real_factors] if out.is_complex() else 2) * fma
    if name in ("addmm", "baddbmm", "addmv"):
        flops += (2 if out.is_complex() else 1) * out.numel()
    return flops


def pow_work(args, out: torch.Tensor) -> tuple[int, int]:
    """(operations, transcendentals) per element of ``pow``: an integer
    exponent ``e`` is ``|e| - 1`` multiplications (at least one, and a
    reciprocal if negative), any other exponent a transcendental."""
    exponent = args[1]
    mult = 6 if out.is_complex() else 1
    if isinstance(exponent, (int, float)) and float(exponent).is_integer() and exponent != 0:
        work = max(int(abs(exponent)) - 1, 1) * mult
        return work + (mult if exponent < 0 else 0), 0
    return (4 if out.is_complex() else 0), (3 if out.is_complex() else 1)


SPECIAL = {"_to_copy", "pow", "linalg_lu_factor_ex", "_linalg_slogdet", "linalg_inv_ex",
           "linalg_lu_solve", "_linalg_solve_ex", "_softmax", "_softmax_backward_data",
           "linalg_vector_norm"}
KNOWN = (MOVES | PRODUCTS | ELEMENTWISE | set(ELEMENTWISE_WORK) | TRANSCENDENTAL | REDUCTIONS
         | SPECIAL)


def rule(name: str, args, kwargs, out) -> tuple[int, int]:
    """(operations, transcendentals) of one aten operation; raises
    :class:`UncountedOp` for an operation with no rule.  An in-place
    operation (``name_``) takes the rule of ``name``."""
    if name not in KNOWN and name.endswith("_") and name[:-1] in KNOWN:
        name = name[:-1]
    inputs = _tensors((args, kwargs))
    outputs = _tensors(out)
    cplx = _is_complex(inputs) or _is_complex(outputs)
    n_out = sum(v.numel() for v in outputs)
    if name in MOVES:
        return 0, 0
    if name == "_to_copy":
        src, dst = inputs[0], outputs[0]
        return (dst.numel() if src.dtype != dst.dtype else 0), 0
    if name in PRODUCTS:
        return product_flops(name, args, outputs[0]), 0
    if name == "pow":
        work, trans = pow_work(args, outputs[0])
        return work * n_out, trans * n_out
    if name in ("linalg_lu_factor_ex", "_linalg_slogdet", "linalg_inv_ex", "linalg_lu_solve",
                "_linalg_solve_ex"):
        a = inputs[0]
        n = a.shape[-1]
        if name == "linalg_lu_factor_ex":
            return lapack_flops([getrf(n)], cplx, _batch(a)), 0
        if name == "_linalg_slogdet":
            # LU, then the product of the diagonal's phases and its logs.
            diagonal = _batch(a) * n
            return lapack_flops([getrf(n)], cplx, _batch(a)) + diagonal * (6 if cplx else 1), diagonal
        if name == "linalg_inv_ex":
            return lapack_flops([getrf(n), getri(n)], cplx, _batch(a)), 0
        b = inputs[2] if name == "linalg_lu_solve" else inputs[1]
        nrhs = 1 if b.ndim == 1 else b.shape[-1]
        batch = _batch(b) if b.ndim > 1 else 1
        if name == "linalg_lu_solve":
            return lapack_flops([getrs(n, nrhs)], cplx, batch), 0
        return lapack_flops([getrf(n), getrs(n, nrhs)], cplx, max(_batch(a), 1)), 0
    if name == "_softmax":
        # max, shift, exp, sum, divide
        return 4 * n_out, n_out
    if name == "_softmax_backward_data":
        return 4 * n_out, 0
    if name == "linalg_vector_norm":
        # a square (|z|^2 of a complex z is 3) and a sum an element, a root an output
        return inputs[0].numel() * (4 if cplx else 2), outputs[0].numel()
    if name in REDUCTIONS:
        n_in = inputs[0].numel()
        if name == "trace":
            n_in = min(inputs[0].shape)
        work = n_in * (2 if cplx else 1)
        if name == "prod" and cplx:
            work = 6 * n_in
        if name == "mean":
            work += n_out * (2 if cplx else 1)
        if name == "nansum":
            work *= 2  # the NaN test and the sum
        return work, 0
    if name in TRANSCENDENTAL:
        if cplx and name in COMPLEX_WORK:
            return COMPLEX_WORK[name] * n_out, COMPLEX_TRANSCENDENTALS[name] * n_out
        return ELEMENTWISE_WORK.get(name, 0) * n_out, TRANSCENDENTAL_WORK.get(name, 1) * n_out
    if name in ELEMENTWISE or name in ELEMENTWISE_WORK:
        per = ELEMENTWISE_WORK.get(name, 1)
        if cplx:
            operands = [a for a in args[:2] if isinstance(a, complex)
                        or (isinstance(a, torch.Tensor) and a.is_complex())]
            if name in COMPLEX_WORK and len(operands) == (2 if name in ("mul", "div") else 1):
                return COMPLEX_WORK[name] * n_out, COMPLEX_TRANSCENDENTALS.get(name, 0) * n_out
            per *= 2  # each of the real and imaginary parts
        return per * n_out, 0
    raise UncountedOp(f"no operation count for aten.{name}")


def op_class(name: str, tensors) -> str:
    """The class whose peak bounds the operation: the products by their dtype,
    complex arithmetic, and every other operation (float32 and narrower)."""
    if _is_complex(tensors):
        return "complex"
    if name in PRODUCTS:
        if any(v.dtype in (torch.bfloat16, torch.float16) for v in tensors):
            return "bf16 products"
        return "float32 products"
    return "other float32"


class OpCounter(TorchDispatchMode):
    """Counts every aten operation run under it into ``self.count``; ``self.ops``
    holds the number of calls of each operation that is not a view.

    The complex casts of real tensors are followed (by storage, while the cast
    lives) so that a product with one is counted as real products.
    """

    def __init__(self):
        super().__init__()
        self.count = Count()
        self.ops: collections.Counter = collections.Counter()
        self.real_casts: weakref.WeakValueDictionary = weakref.WeakValueDictionary()

    def _real_cast(self, t: torch.Tensor) -> bool:
        cast = self.real_casts.get(t.untyped_storage().data_ptr())
        return cast is not None and t.is_complex()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = func.overloadpacket.__name__
        if name in VIEWS:
            return out
        tensors = _tensors((args, kwargs))
        if name == "sort":
            values = tensors[0]
            dim = args[1] if len(args) > 1 and isinstance(args[1], int) else kwargs.get("dim", -1)
            length = values.shape[dim] if values.ndim else 1
            self.count.sorts.append((values.numel() // max(length, 1), length))
        elif name in PRODUCTS and out.is_complex():
            factors = tensors[1:3] if name in ("addmm", "baddbmm", "addmv") else tensors[:2]
            real = sum(self._real_cast(v) for v in factors)
            self.count.flops["float32 products" if real else "complex"] += product_flops(
                name, args, out, real)
        else:
            flops, trans = rule(name, args, kwargs, out)
            self.count.flops[op_class(name, tensors)] += flops
            self.count.transcendentals += trans
            if name == "_to_copy" and out.is_complex() and not tensors[0].is_complex():
                self.real_casts[out.untyped_storage().data_ptr()] = out
        self.count.bytes += sum(v.numel() * v.element_size() for v in tensors + _tensors(out))
        self.ops[name] += 1
        return out


def sort_flops(sorts, scale: int = 1, per: int = 1) -> int:
    """``rows L ceil(log2 L)`` of each sorted ``(rows, L)``, with ``L`` taken
    as ``L * scale / per`` (the rows of a sort hold the walkers)."""
    total = 0
    for rows, length in sorts:
        length = length * scale // per
        total += rows * length * max(math.ceil(math.log2(length)), 1) if length > 1 else 0
    return total


def counted(fn):
    """``(Count, fn())``: ``fn`` run under a fresh :class:`OpCounter`."""
    with OpCounter() as counter:
        out = fn()
    return counter.count, out


def carry(low: Count, high: Count, batches: tuple[int, int], target: int) -> dict:
    """The count at ``target`` walkers from the counts at ``batches``: the
    affine part carried along the line through both, the sorts evaluated at
    their carried lengths.  Raises if the sorts do not scale with the walkers."""
    b0, b1 = batches
    steps, rem = divmod(target - b0, b1 - b0)
    if rem:
        raise ValueError(f"{target} walkers is not {b0} + a multiple of {b1 - b0}")
    lo, hi = low.affine(), high.affine()
    out = {k: lo[k] + steps * (hi[k] - lo[k]) for k in lo}
    scaled = [(r0, l0) for (r0, l0), (r1, l1) in zip(low.sorts, high.sorts)
              if r0 == r1 and l0 * b1 == l1 * b0]
    if len(low.sorts) != len(high.sorts) or len(scaled) != len(low.sorts):
        raise ValueError(f"the sorts do not scale with the walkers: {low.sorts} {high.sorts}")
    out["other float32"] += sort_flops(low.sorts, target, b0)
    return out


def summary(count: dict) -> dict:
    """Totals and the least times of one iteration's count (ms, from the peaks)."""
    flops = sum(count[c] for c in CLASSES)
    class_ms = {c: count[c] / PEAK_FLOPS[c] * 1e3 for c in CLASSES}
    ops_ms = sum(class_ms.values()) + count["transcendentals"] / PEAK_FLOPS["other float32"] * 1e3
    return {"flops": flops, "transcendentals": count["transcendentals"], "bytes": count["bytes"],
            "by_class": {c: count[c] for c in CLASSES}, "class_ms": class_ms,
            "operations_ms": ops_ms, "bytes_ms": count["bytes"] / MEMORY_RATE * 1e3}
