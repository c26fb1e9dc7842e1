"""KFAC's Kronecker factors as Gram products (``ops/kfac_gram.py``).

On the CPU: :func:`gram_plain` against ``x.T @ x / rows`` with and without
the bias's ones column; ``gram`` on CPU tensors is the plain version and
launches nothing; ``factor_update`` forms every Kronecker factor as the
concatenation and ``torch.matmul`` did, bit for bit, and counts each as
``kfac.factors`` (none as ``kfac.gram``, which only the card's kernel counts);
:func:`plan`'s tiles and chunks at every shape the benchmark's cells form.

On a card (marked ``cuda``, skipped elsewhere): the kernel at every shape
the cells form and at ragged ones, against a float64 product: exactly
symmetric, and no farther from float64 in the Frobenius norm than twice
``torch.matmul`` in float32 with TF32 off on the same inputs.  Run them on
the card with

    python -m pytest tests/test_torch_kfac_gram.py -m cuda --noconftest
"""

from __future__ import annotations

import pytest
import torch

from deephall_tpu_torch import config, tracing
from deephall_tpu_torch.loss import make_loss_and_capture_fn
from deephall_tpu_torch.networks import make_network
from deephall_tpu_torch.ops import kfac_gram
from deephall_tpu_torch.optimizers import kfac
from deephall_tpu_torch.weights import init_params

torch.set_num_threads(2)

SMS = 132  # an H100's SMs

# (rows, columns, ones column) of every Kronecker factor of the benchmark's
# training cells: batch 3360 at N = 6 and N = 10; the inputs of Dense_0 (4),
# of a layer with a bias (256 and its ones column) and without (256); the
# head's G at one determinant (N = 6: 96, N = 10: 280) and at 16 (4,480).
CELL_SHAPES = [
    (20160, 4, False), (20160, 256, True), (20160, 256, False), (20160, 96, False),
    (33600, 4, False), (33600, 256, True), (33600, 256, False), (33600, 280, False),
    (33600, 4480, False),
]


def matrix(rows: int, cols: int, seed: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Normal entries about a column mean of 0.5: the column sums matter."""
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn(rows, cols, generator=gen, dtype=torch.float64) + 0.5).to(dtype).to(device)


def with_ones(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones((x.shape[0], 1), dtype=x.dtype, device=x.device)], -1)


# --- on the CPU ------------------------------------------------------------------


@pytest.mark.parametrize("rows,cols", [(300, 7), (257, 40)])
@pytest.mark.parametrize("ones", [False, True], ids=["plain", "ones_column"])
def test_gram_plain_is_the_matmul(rows, cols, ones):
    x = matrix(rows, cols, rows + cols)
    full = with_ones(x) if ones else x
    got = kfac_gram.gram_plain(x, ones)
    assert got.dtype == torch.float32 and got.shape == (cols + ones, cols + ones)
    assert torch.equal(got, (full.T @ full) / rows)
    want = (full.double().T @ full.double()) / rows
    assert torch.allclose(got.double(), want, rtol=1e-5, atol=1e-6)
    if ones:  # the bias's column and row: column means, and the corner 1
        assert got[-1, -1] == 1
        assert torch.allclose(got[:-1, -1].double(), x.double().mean(0), rtol=1e-5, atol=1e-6)
        assert torch.equal(got[-1, :-1], got[:-1, -1])


def test_gram_on_the_cpu_is_the_plain_version():
    x = matrix(200, 12, 3)
    before = kfac_gram.gram.launches
    for ones in (False, True):
        assert torch.equal(kfac_gram.gram(x, ones), kfac_gram.gram_plain(x, ones))
    assert kfac_gram.gram.launches == before


@pytest.fixture(scope="module")
def captured():
    """A small Psiformer's captured inputs and sensitivities (N = 3 in both
    spin sectors, 2Q = 4, one layer of 2 heads x 4) at 16 walkers."""
    cfg = config.Config.from_dict({
        "system": {"nspins": [2, 1], "flux": 4},
        "network": {"psiformer": {"num_layers": 1, "num_heads": 2, "heads_dim": 4}},
    })
    model = make_network(cfg.system, cfg.network)
    init_params(model, torch.Generator().manual_seed(5))
    gen = torch.Generator().manual_seed(11)
    theta = torch.acos(2 * torch.rand(16, 3, generator=gen) - 1)
    phi = (2 * torch.rand(16, 3, generator=gen) - 1) * torch.pi
    _, _, inputs, dy = make_loss_and_capture_fn(model, cfg.system)(torch.stack([theta, phi], -1))
    return kfac.discover(model, 3), inputs, dy


def test_factor_update_forms_the_factors_as_before(captured):
    """Every Kronecker factor as the parent formed it: the ones column
    concatenated for a bias, then ``(a.T @ a) / rows``; bit for bit."""
    specs, inputs, dy = captured
    kron, _ = kfac.factor_update(specs, inputs, dy)
    krons = [spec for spec in specs if spec.kind == "kron"]
    assert sorted(kron) == sorted(spec.path for spec in krons)
    assert any(spec.has_bias for spec in krons) and not all(spec.has_bias for spec in krons)
    for spec in krons:
        a, g = inputs[spec.path], dy[spec.path]
        rows = a.shape[0]
        if spec.has_bias:
            a = torch.cat([a, torch.ones((rows, 1), dtype=a.dtype)], -1)
        assert torch.equal(kron[spec.path]["a"], (a.T @ a) / rows), spec.path
        assert torch.equal(kron[spec.path]["g"], (g.T @ g) / rows), spec.path


def test_each_factor_is_counted(captured):
    """Two ``kfac.factors`` a Kronecker block in the open block record; on
    the CPU no ``kfac.gram``."""
    specs, inputs, dy = captured
    with tracing.block(1, torch.device("cpu")):
        kfac.factor_update(specs, inputs, dy)
    counts = tracing.blocks()[-1].counts
    assert counts["kfac.factors"] == 2 * sum(spec.kind == "kron" for spec in specs)
    assert "kfac.gram" not in counts


@pytest.mark.parametrize("rows,cols,ones", CELL_SHAPES + [(1000, 128, True), (37, 5, False)])
def test_the_plan_covers_the_triangle_and_fills_the_card(rows, cols, ones):
    plan = kfac_gram.plan(rows, cols, SMS)
    blocks = -(-cols // kfac_gram.TILE)  # the ones column adds no tile
    assert plan.tiles == blocks * (blocks + 1) // 2
    steps = -(-rows // kfac_gram.STEP)
    # Every chunk has rows; together they cover every step once.
    assert (plan.chunks - 1) * plan.chunk_steps < steps <= plan.chunks * plan.chunk_steps
    if plan.tiles >= SMS:
        assert plan.chunks == 1
    else:
        assert plan.tiles * plan.chunks <= SMS
        assert plan.chunks == 1 or plan.chunk_steps >= kfac_gram.MIN_CHUNK_STEPS


def test_the_plans_of_the_cells():
    """The 16-determinant head's G: 630 tiles in one chunk; a layer's A with
    its bias: three tiles, 44 chunks; Dense_0's inputs: one tile in 70 chunks
    of 9 steps at N = 6."""
    assert kfac_gram.plan(33600, 4480, SMS) == (630, 1, 1050)
    assert kfac_gram.plan(33600, 256, SMS) == (3, 44, 24)
    assert kfac_gram.plan(20160, 4, SMS) == (1, 70, 9)


# --- on the card -----------------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def frobenius_error(got: torch.Tensor, want: torch.Tensor) -> float:
    return float(torch.linalg.norm(got.double() - want) / torch.linalg.norm(want))


# The cells' shapes; rows not a multiple of the 32-row step; widths not a
# multiple of the 128-column tile, and off the 16-byte grid (copied float by
# float).
CARD_SHAPES = CELL_SHAPES + [(20161, 256, True), (4001, 200, False), (3001, 300, True),
                             (2003, 15, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,ones", CARD_SHAPES)
def test_the_kernel_against_float64(device, rows, cols, ones):
    x = matrix(rows, cols, rows + cols, device=device)
    before = kfac_gram.gram.launches
    got = kfac_gram.gram(x, ones)
    torch.cuda.synchronize()
    assert kfac_gram.gram.launches == before + 1
    assert got.shape == (cols + ones, cols + ones)
    assert torch.equal(got, got.T)
    assert torch.equal(got, kfac_gram.gram(x, ones))  # the chunks are added in a fixed order
    full = with_ones(x.double()) if ones else x.double()
    want = (full.T @ full) / rows
    assert not torch.backends.cuda.matmul.allow_tf32
    library = kfac_gram.gram_plain(x, ones)  # torch.matmul in float32
    err, library_err = frobenius_error(got, want), frobenius_error(library, want)
    assert err <= 2 * library_err, (err, library_err)
    if ones:
        assert got[-1, -1] == 1


@pytest.mark.cuda
def test_a_single_column(device):
    """One column (copied float by float): a single sum, so the library's
    error is one rounding and twice it can be zero.  The value lies within
    eight float32 half-ulps of float64: the kernel adds a chunk's eight steps
    of partial sums in float32."""
    x = matrix(1000, 1, 1001, device=device)
    got = kfac_gram.gram(x)
    want = (x.double().T @ x.double()) / 1000
    assert got.shape == (1, 1)
    assert torch.allclose(got.double(), want, rtol=8 * 2.0**-24, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("view", ["columns", "every_other", "transposed"])
def test_a_strided_view_is_read_in_place(device, view):
    """Columns 8..263 of a wider matrix (the parent's row stride), every other
    column, and a transposed matrix: as the contiguous copy gives."""
    parent = matrix(5000, 600, 7, device=device)
    x = {"columns": parent[:, 8:264], "every_other": parent[:, ::2],
         "transposed": parent[:300].T}[view]
    got = kfac_gram.gram(x, True)
    assert torch.equal(got, kfac_gram.gram(x.contiguous(), True))


@pytest.mark.cuda
def test_the_kernel_raises_on_what_it_does_not_take(device):
    with pytest.raises(TypeError):
        kfac_gram.gram(torch.ones(64, 8, dtype=torch.float64, device=device))
    with pytest.raises(TypeError):
        kfac_gram.gram(torch.ones(4, 64, 8, device=device))
    with pytest.raises(ValueError):
        kfac_gram.gram(torch.ones(0, 8, device=device))
