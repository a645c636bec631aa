"""Fixtures of the benchmark's own tests.  Run them from the root of the
repository: ``python -m pytest qtbench/tests -q``.  Tests marked ``card``
need a CUDA card and skip without one; on the card they run with the
same command."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips on a machine without one)")


@pytest.fixture
def card():
    """Skip unless a CUDA card is visible (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; none is visible")
    return torch.device("cuda")


# Small sizes of each configuration for CPU runs of the harness.  The
# random circuit keeps its full depth: the control's error grows with it,
# and at depth 3 the "bf16_3x" control stays under the cell's limits.
TINY = {"rc26": {"num_qubits": 15, "depth": 20},
        "qft30": {"num_qubits": 15}}


@pytest.fixture
def tiny():
    return TINY
