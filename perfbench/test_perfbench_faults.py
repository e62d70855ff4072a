"""The comparison that decides ``correct`` has teeth: a whole run of the
harness, past its look for a card, on the CPU at a small size, with the
cell's own limits — sound, then with each fault the cell can have
planted in the program underneath, then with the control (the reference
with float8 products in the program's place)."""

import pytest

from perfbench import bench, check, faults
from perfbench.smoke import small_cell

CELLS = ("glm4-9b.train-4k", "mamba2-1.3b.train-2k")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result = bench.run(small_cell(name), 2 ** 31 + 101, 0.2, False,
                       device="cpu")
    assert result["correct"], result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    # run.py prints ``readings`` apart and ``checks`` last on the line
    assert list(result)[-2:] == ["checks", "readings"]
    assert set(result["metrics"]) == {"setup_s", "train_tokens_per_s",
                                      "peak_mem_gb"}


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    with faults.FAULTS[fault]():
        result = bench.run(small_cell(name), 2 ** 31 + 102, 0.2, False,
                           device="cpu")
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small_cell(name)
    seed = 2 ** 31 + 103
    ref = bench.reference(cell, seed, "cpu")
    ctl = bench.reference(cell, seed, "cpu", precision="fp8")
    values, _ = check.numbers(ctl, ref)
    assert not check.judge(values, cell.limits), values


def test_state_unchanged_reads_one():
    cell = small_cell("glm4-9b.train-4k")
    with faults.state_unchanged():
        prog = bench.Program(cell, 5, "cpu")
        mine = prog.follow()
    prog.close()
    values, _ = check.numbers(mine, bench.reference(cell, 5, "cpu"))
    assert values["change_gap"] == pytest.approx(1.0)
    assert values["grad_gap"] == pytest.approx(1.0)


@pytest.mark.parametrize("fault", sorted(faults.MIXER_FAULTS["mamba2"]))
def test_mixer_fault_changes_the_gradient_and_not_the_forward(fault):
    """Each fault of the SSD scan's backward leaves the first loss as it
    was and moves the top layer's gradient of some leaf by more than the
    sound run's gap (which faults the limits catch is read on the card,
    at the cell's own size)."""
    cell = small_cell("mamba2-1.3b.train-2k")
    seed = 2 ** 31 + 104
    ref = bench.reference(cell, seed, "cpu")
    sound = bench.Program(cell, seed, "cpu")
    mine = sound.follow()
    sound.close()
    with faults.MIXER_FAULTS["mamba2"][fault]():
        prog = bench.Program(cell, seed, "cpu")
        broken = prog.follow()
        prog.close()
    assert broken.losses[0] == mine.losses[0]
    ok, _ = check.numbers(mine, ref)
    bad, _ = check.numbers(broken, ref)
    assert bad["grad_diff_top_worst"] > 5 * ok["grad_diff_top_worst"], \
        (ok, bad)
