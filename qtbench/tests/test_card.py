"""The control at each cell's own size, on the card: the cell's control
in the program's place reads above the cell's limits, and the program
itself within them.  Run on the card: ``python -m pytest qtbench/tests
-q -m card``."""

import time

import pytest

from qtbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell, card):
    harness.set_cache_dirs()
    for control, seed in ((False, 2 ** 31 + 501), (True, 2 ** 31 + 502)):
        result, readings = harness.run_cell(
            cell, seed, 3.0, False, t_start=time.perf_counter(),
            control=control)
        assert result["correct"] is (not control), readings
