"""The control, the plain reference in the nearest precision below the
configuration's (bf16 operands, float32 sums) put in the program's place,
goes through the run's own comparison and verdict and comes out not
correct: on the CPU at a small size, and on the card at the cell's own
size."""

import pytest

from benchmark import control

CELLS = ("mf_year_screen", "mf_year_high", "bp_lattice_day")


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_a_small_size(root, small, cell):
    for seed in (1, 2, 3):
        r = control.readings(root, cell, seed, 2, "cpu",
                             overrides=small(cell))
        assert r["correct"] is False and r["failed"] >= 1, (seed, r)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(root, cuda, cell):
    r = control.readings(root, cell, 2 ** 31 + 5, 2, cuda)
    assert r["correct"] is False and r["failed"] >= 1, r
