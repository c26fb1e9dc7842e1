"""``correct`` comes out false when the timed path is broken underneath.

Each test skips the harness's look for a card and drives the rest of a run
on the CPU (the port's plain kernels, the cell's own widths, few walkers):
set-up with its recorded iterations, a short window, and the comparison with
the reference under the cell's own limits.  The control (the reference in
float32 with TF32 products in the program's place) needs the card.
"""

import pytest
import torch

from benchmark import run
from benchmark.harness import cells

CPU = torch.device("cpu")
SEED = 2**31 + 12345


def _decide(name, fault=None, batch=16):
    cell = cells.load_cell(name)
    result = run.drive(cell, SEED, 1.0, CPU, batch=batch, fault=fault)
    return run.decide(cell, result, SEED, CPU)


@pytest.mark.parametrize("name", ["n6q15.train_l2", "n10q27.infer_lean"])
def test_the_program_as_it_stands_reads_near_its_limits(name):
    """The limits are set at 3360 walkers; a mean over 8 walkers averages
    less round-off away, so the unbroken run is held to ten times them."""
    _, table = _decide(name, batch=8)
    assert all(row["value"] < 10 * row["limit"] for row in table.values()), table


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered", "sweep_unchanged"])
def test_a_fault_under_a_training_cell_is_caught(fault):
    correct, table = _decide("n6q15.train_l2", fault)
    assert not correct, table


@pytest.mark.parametrize("fault", ["half_batch", "altered", "sweep_unchanged"])
def test_a_fault_under_an_inference_cell_is_caught(fault):
    correct, table = _decide("n10q27.infer_lean", fault, batch=8)
    assert not correct, table


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["n6q15.train_l2", "n10q27.infer_lean"])
def test_the_control_is_not_correct(name):
    """The reference in float32 with TF32 products, in the program's place on
    the walkers that a run at 1120 walkers checks, fails a number."""
    if not torch.cuda.is_available():
        pytest.skip("the control's TF32 products need a CUDA card")
    device = torch.device("cuda:0")
    cell = cells.load_cell(name)
    result = run.drive(cell, SEED, 3.0, device, batch=1120)
    _, control = run.compare(cell, result, SEED, device, control=True)
    assert any(control[k] > limit for k, limit in cell.limits.items() if k in control), control
