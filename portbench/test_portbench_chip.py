"""The controls on the card: each cell's control, at a size a test run can
hold, comes out not ``correct`` against the cell's limits.

    python -m pytest portbench -q -m chip      (on a machine with a CUDA card)

The limits were set from the controls at the cells' own sizes
(``python -m portbench.control``; readings in ``PERF.md``).
"""
from __future__ import annotations

from pathlib import Path

import pytest

from portbench import control, core
from portbench.reference import compare

ROOT = Path(__file__).resolve().parents[1]
SMALL = {"bf16_batch32": {"batch": 8, "distinct_batches": 2, "check_batches": 2},
         "int8_batch32": {"batch": 8, "distinct_batches": 2},
         "train_bs16": {"batch": 8}}


@pytest.mark.chip
@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_is_not_correct(name, cuda):
    cell = core.load_cell(name, ROOT)
    cell.traffic.update(SMALL[name])
    numbers, _ = control.reading(cell, "control", 2**32 + 3, 3.0, cuda, ROOT)
    ok, checks = compare.judge(numbers, cell.limits)
    assert not ok, checks
