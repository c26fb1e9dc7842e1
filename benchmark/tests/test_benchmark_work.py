"""The frozen work arithmetic: the kernels' work from shapes worked by hand,
and the stored count of an iteration recounted on the CPU."""

import json
import math

import pytest

from benchmark.harness import cells
from benchmark.work import count, counter, kernels


def test_attention_work_by_hand():
    # B=2, T=3, D=8, H=2 (dh=4), C=2 tangents and E=1 extra: C + E + 2 = 5 planes.
    nbytes, core, projections = kernels.attention_work(2, 3, 8, 2, 2, 1)
    elems = 5 * 2 * 3 * 8
    assert nbytes == 2 * elems * 4 + 4 * (64 + 8) * 4
    # per (walker, head, query, source): 1 + 2*2 + 2 + (2-1) + 3*1 = 11 dot products of 4 terms, two contractions
    assert core == 2 * 2 * 4 * 9 * 2 * 2 * 11
    assert projections == 4 * 2 * elems * 8


def test_layernorm_bytes_by_hand():
    planes = 2 + 1 + 2  # C + E + 2
    assert kernels.layernorm_bytes(2, 3, 8, 2, 1, residual=False) == planes * 48 * 4 * 2
    assert kernels.layernorm_bytes(2, 3, 8, 2, 1, residual=True) == planes * 48 * 4 * 3


def test_the_kernel_tables_bounds():
    """The N=6 and N=10 bounds of the kernel table: 1.381 and 2.912 ms by the
    operations, 0.370 ms by the bytes (B=3360, D=256, H=4)."""
    assert kernels.attention_least(3360, 6, 256, 4, 15, 3) == pytest.approx((1.381e-3, "operations"), rel=1e-3)
    assert kernels.attention_least(3360, 10, 256, 4, 21, 1).seconds == pytest.approx(2.912e-3, rel=1e-3)
    assert kernels.layernorm_least(3360, 6, 256, 15, 3, True) == pytest.approx((0.370e-3, "bytes"), rel=1e-3)
    assert kernels.jet_channels(6, True) == (15, 3) and kernels.jet_channels(10, False) == (21, 1)


def test_lapack_counts_by_hand():
    assert counter.getrf(2) == (4, 1)  # (8 + 4) // 3 multiplications, one addition
    assert counter.lapack_flops([counter.getrf(2)], True, 3) == 3 * (6 * 4 + 2 * 1)


def test_carry_is_affine():
    low, high = counter.Count(), counter.Count()
    low.flops["complex"], high.flops["complex"] = 10, 14
    low.bytes, high.bytes = 100, 180
    out = counter.carry(low, high, (16, 32), 48)
    assert out["complex"] == 18 and out["bytes"] == 260
    with pytest.raises(ValueError):
        counter.carry(low, high, (16, 32), 50)


def test_stored_count_recounted():
    """The main path's stored count is the one a recount gives (16 and 32
    walkers carried, checked at 48), and its least time is PERF.md's 6.13 ms."""
    cell = cells.load_cell("n6q15.train_l2")
    stored = json.loads(cells.work_path(cell.config_name, cell.job_name).read_text())
    fresh = counter.summary(count.per_iteration(cell))
    assert fresh["flops"] == stored["flops"] and fresh["bytes"] == stored["bytes"]
    assert math.isclose(stored["operations_ms"], 6.135, rel_tol=1e-3)


def test_every_cell_has_its_count():
    bench = cells.load_benchmark()
    for w in bench["workloads"]:
        stored = json.loads(cells.work_path(w["config"], w["traffic"]).read_text())
        assert stored["batch"] == 3360 and stored["operations_ms"] > 0
