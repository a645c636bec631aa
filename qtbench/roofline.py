"""The yardstick of the roofline metrics: the card's published peaks and
the bytes and operations of each launch.

A frozen copy of the arithmetic of ``quest_tpu_torch/probes/common.py``
(``state_pass_bytes``, ``pass_flops``, ``least_ms``), with one change: the
window products are held to the card's dense TF32 rate, the highest rate
at which any product of float32 inputs runs on an H100 SXM, and not to a
third of it (the port's own float32-accurate split).  No implementation
of the same work at float32 accuracy can then read over 100 %.

Peaks: NVIDIA H100 SXM data sheet, dense, at the card's full power limit
of 700 W (the harness prints the card's limit beside every run).
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12

# The window's side: 128 amplitudes per product row (7 qubits).
WINDOW_DIM = 128


def least_s(nbytes: float, flops: float) -> float:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the dense TF32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / TF32_FLOPS_PER_S)


def state_pass_bytes(num_amps: int, itemsize: int = 4) -> int:
    """One read and one write of every amplitude (both planes) of a
    state of ``num_amps`` amplitudes."""
    return 2 * 2 * itemsize * num_amps


def window_pass_flops(num_amps: int, rank: int, sides: int,
                      mask: bool) -> float:
    """Real operations of one window pass: 8 per complex multiply-add,
    WINDOW_DIM per output amplitude per side per rank, plus 6 per
    amplitude for a mask (a complex multiply)."""
    return (8.0 * WINDOW_DIM * rank * sides * num_amps
            + (6.0 * num_amps if mask else 0.0))


def window_pass_cost(rank: int, sides: int, mask: bool, num_amps: int,
                     itemsize: int = 4):
    """(bytes, operations) of one window pass over ``num_amps``
    amplitudes (a bank's: every element's)."""
    return (state_pass_bytes(num_amps, itemsize),
            window_pass_flops(num_amps, rank, sides, mask))


def group_cost(passes, num_amps: int, itemsize: int = 4):
    """(bytes, operations) of one launch that runs several window passes
    over the state once (a megawin group): the state is read and written
    once, each pass's products counted.  ``passes`` holds (rank, sides,
    mask) triples."""
    flops = sum(window_pass_flops(num_amps, r, s, m) for r, s, m in passes)
    return state_pass_bytes(num_amps, itemsize), flops
