"""The control comes out not correct: the plain reference in the program's
place, computed in the precision below the cell's (float32 cells: TF32;
bf16 cells: fp8), fails at least one of the cell's numbers."""

import json

import pytest

import tiny
from portbench import control
from portbench.core import layout

SEEDS = [2**31 + 31, 2**31 + 32, 2**31 + 33]


def test_fp8_control_fails_on_the_cpu():
    """fp8 needs no card: the latency cell's control at a test's size, as
    a bf16 cell would have it."""
    cell = tiny.cell("sp-lg.latency-b1")
    cell.cell = dict(cell.cell, precision="bf16")
    for _, numbers, _ in control.readings(cell, "control", SEEDS[:1], "cpu"):
        assert control.failed(cell, numbers), numbers


CELLS = [w["name"] for w in layout.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    """Each cell's control on the card at the cell's own size (its pool,
    the requests its check judges), three seeds."""
    cell = layout.Cell(name)
    for seed, numbers, _ in control.readings(cell, "control", SEEDS, card):
        assert control.failed(cell, numbers), json.dumps(numbers)
