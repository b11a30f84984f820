"""On a CUDA card, at the cells' own sizes: a short run of each cell is
correct, and the fp8 control fails one of its numbers. Run on the card with
``python -m pytest portbench/tests/test_card.py -q``; skips elsewhere."""

import time

import pytest

from portbench import control, harness

CELLS = [w["name"] for w in harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_short_run_is_correct(cell, card):
    r = harness.run_cell(cell, 2 ** 31 + 808, 5.0, False, time.perf_counter(), device=card)
    assert r["correct"], r["checks"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_a_number(cell, card):
    checks = control.readings(cell, 2 ** 31 + 909, card)
    assert any(c["value"] > c["limit"] for c in checks), checks
