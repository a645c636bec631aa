"""The control at each cell's own size, on the card: the cell's control
in the program's place reads above the cell's limits, and the program
itself within them; and the same for a register split into four shards on
one card.  Run on the card: ``python -m pytest qtbench/tests -q -m
card``."""

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


@pytest.mark.card
def test_split_register_on_one_card(card):
    """rc26.api's circuit at 28 qubits on four shards of one card (the
    drain's exchanges, remaps and sharded gathers, and the reference in
    four chunks): correct under the cell's limit, its control above it."""
    harness.set_cache_dirs()
    for control, seed in ((False, 2 ** 31 + 503), (True, 2 ** 31 + 504)):
        result, readings = harness.run_cell(
            "rc26.api", seed, 3.0, False, t_start=time.perf_counter(),
            devices=["cuda:0"] * 4, overrides={"num_qubits": 28},
            control=control)
        assert result["correct"] is (not control), readings
