"""On the card, at each cell's own size: the program's followed steps are
within the cell's limits and the control (the reference with float8
products in the program's place), the ``half_batch`` fault and two
faults of the SSD scan's backward are not.
Run on a machine with a CUDA card from the root of a checkout::

    PYTHONPATH=src python -m pytest -m chip perfbench/test_perfbench_chip.py
"""

import pytest

from perfbench import bench, check, faults

CELLS = ("glm4-9b.train-4k", "mamba2-1.3b.train-2k")
SEED = 2 ** 31 + 977


def _program(cell, seed, device):
    prog = bench.Program(cell, seed, device)
    try:
        return prog.follow()
    finally:
        prog.close()


@pytest.mark.chip
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_and_fault_fail(name, cuda):
    cell = bench.Cell.load(name)
    mine = _program(cell, SEED, cuda)
    ref = bench.reference(cell, SEED, cuda)
    values, _ = check.numbers(mine, ref)
    assert check.judge(values, cell.limits), values
    ctl = bench.reference(cell, SEED, cuda, precision="fp8")
    values, _ = check.numbers(ctl, ref)
    assert not check.judge(values, cell.limits), values
    with faults.half_batch():
        values, _ = check.numbers(_program(cell, SEED, cuda), ref)
    assert not check.judge(values, cell.limits), values


@pytest.mark.chip
@pytest.mark.parametrize("fault", ["ssd_grad_scaled", "ssd_grad_no_decay"])
def test_mixer_backward_faults_fail_the_mamba2_limits(fault, cuda):
    """At the cell's own size a scaled SSD backward moves the three-step
    loss, and one without the decay's gradient the change of the
    parameters, past their limits (``ssd_grad_no_bc`` reads inside the
    sound runs' readings there: PERF.md §6)."""
    cell = bench.Cell.load("mamba2-1.3b.train-2k")
    ref = bench.reference(cell, SEED, cuda)
    with faults.MIXER_FAULTS["mamba2"][fault]():
        values, _ = check.numbers(_program(cell, SEED, cuda), ref)
    assert not check.judge(values, cell.limits), values
