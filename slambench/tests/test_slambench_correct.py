"""`correct` comes out true for the program and false for the control and
for each fault a reloc cell can have, with the cells' own limits. Small
configurations on the CPU, where the program runs its plain versions; the
card's readings are in PERF.md."""

import pytest
import torch

from slambench import run
from slambench.faults import FAULTS
from slambench.drivers import reloc
from slambench.tests.conftest import CELLS, small_config, small_traffic

SEED = 2**31 + 101


def _run(workload, patch=None):
    return run.run_cell(workload, SEED, 12.0, False, "cpu", cfg=small_config(CELLS[workload]),
                        traffic=small_traffic(), patch=patch)


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_program_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["check"]
    assert out["compared"]["compared_sweeps"] > 0 and out["compared"]["compared_images"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_fault_is_not_correct(workload, fault):
    out = _run(workload, patch=FAULTS[fault])
    assert not out["correct"], out["check"]


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_control_is_not_correct(workload):
    """The plain reference at bfloat16 in the program's place fails the limits."""
    cell = reloc.Cell(small_config(CELLS[workload]), small_traffic(), SEED, torch.device("cpu"),
                      0.0)
    cell.free_program()
    numbers = cell.check(cell.control({"requests": []}))
    limits = run.load_limits(workload)
    assert any(numbers[k] > lim for k, lim in limits.items()), numbers


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(CELLS))
def test_cell_on_the_card(cuda_device, workload):
    out = run.run_cell(workload, SEED, 3.0, False, "cuda")
    assert out["correct"], out["check"]
    assert out["device"]["platform"] == "gpu"
