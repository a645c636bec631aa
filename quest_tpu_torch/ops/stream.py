"""The HBM stream pass (P1): a copy, or a scale, of the whole state.

The counterpart of the TPU probe ``scripts/probes/profile_dma.py``, whose
Pallas kernel (``make_pallas_chain``, pallas_call at profile_dma.py:52)
streams the canonical (2, hi, 128, 128) view of the state through blocks
of R x 128 x 128 amplitudes of both planes, copying it or doubling it, in
place or into a second buffer, to find the rate a plain pass reaches.  No
circuit path needs this function: it is the yardstick every pass that is
bound by bytes is judged against, measured on the card by
``quest_tpu_torch.probes.profile_dma``.

``stream_pass`` launches the hand-written CUDA kernel
(``csrc/probes.cu`` ``stream_pass_kernel``, one CTA per tile of R rows) on
a float32 state on the card, and only there: a tensor anywhere else
raises, and nothing falls back to the plain version.  ``stream_pass_plain``
is the same function in plain PyTorch; the tests and ``chip_smoke.py``
hold the kernel to it bit for bit.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

ROW_AMPS = 128 * 128     # amplitudes in one row of the canonical view
OPS = ("copy", "scale")
MAX_ROWS = 4096          # csrc/probes.cu: a CTA's tile fits int indices
# launches of the kernel, counted where its wrapper launches it
LAUNCHES = {"P1": 0}
_BOUND: dict = {}


def _rows_of(amps, rows: int, what: str) -> int:
    """hi, the rows of 128 x 128 amplitudes in one plane of ``amps``,
    after checking that R = ``rows`` tiles them."""
    if amps.numel() % (2 * ROW_AMPS):
        raise ValueError(f"{what}: a state of {amps.numel()} reals is not "
                         "two planes of whole 128 x 128 rows (n >= 14)")
    hi = amps.numel() // (2 * ROW_AMPS)
    if hi & (hi - 1):
        raise ValueError(f"{what}: {hi} rows a plane is not a power of two")
    if rows < 1 or hi % rows:
        raise ValueError(f"{what}: R = {rows} does not divide the {hi} rows "
                         "of a plane")
    if rows > MAX_ROWS:
        raise ValueError(f"{what}: R = {rows} rows a CTA is more than the "
                         f"kernel's {MAX_ROWS}")
    return hi


def _check_op(op: str, what: str) -> int:
    if op not in OPS:
        raise ValueError(f"{what}: op {op!r} is not one of {OPS}")
    return OPS.index(op)


def _check_out(amps, out, what: str) -> None:
    if out is None:
        return
    if (out.shape != amps.shape or out.dtype != amps.dtype
            or out.device != amps.device):
        raise ValueError(f"{what}: out must match the state's shape, dtype "
                         "and device")
    if not out.is_contiguous():
        raise ValueError(f"{what}: out must be contiguous")
    nbytes = amps.numel() * amps.element_size()
    a, o = amps.data_ptr(), out.data_ptr()
    if a != o and a < o + nbytes and o < a + nbytes:
        raise ValueError(f"{what}: out overlaps the state without being it")


def stream_pass_plain(amps, *, rows: int, op: str, scale: float = 2.0,
                      out=None):
    """The stream pass in plain PyTorch: ``amps`` copied (op "copy") or
    multiplied by ``scale`` rounded to float32 (op "scale"), written into
    ``out`` or, when ``out`` is None, back into ``amps``; returns the tensor
    written.  ``rows`` is checked as the kernel checks it and changes
    nothing else."""
    what = "stream_pass_plain"
    _rows_of(amps, rows, what)
    k = _check_op(op, what)
    _check_out(amps, out, what)
    dst = amps if out is None else out
    if k == 0:
        if dst is not amps:
            dst.copy_(amps)
        return dst
    s = float(np.float32(scale))
    return torch.mul(amps, s, out=dst)


def _lib():
    if "lib" not in _BOUND:
        lib = build.library()
        ptr = ctypes.c_void_p
        lib.qt_stream_pass.argtypes = [ptr, ptr, ctypes.c_longlong,
                                       ctypes.c_int, ctypes.c_int,
                                       ctypes.c_float, ptr]
        lib.qt_stream_pass.restype = ctypes.c_int
        _BOUND["lib"] = lib
    return _BOUND["lib"]


def stream_pass(amps, *, rows: int, op: str, scale: float = 2.0, out=None):
    """One stream pass (P1) of a contiguous float32 state on the card, any
    full-size view of it ((2, 2^n) or the canonical (2, hi, 128, 128)): one
    CTA per tile of ``rows`` x 128 x 128 amplitudes of both planes, which
    it copies (op "copy") or multiplies by ``scale`` (op "scale").  With
    ``out`` None the pass writes in place and returns ``amps``; else it
    writes ``out`` (same shape, not overlapping) and returns it."""
    what = "stream_pass"
    if amps.device.type != "cuda":
        raise RuntimeError(f"{what}: no kernel for device {amps.device}; "
                           "the stream pass runs only on the card")
    if amps.dtype != torch.float32:
        raise TypeError(f"{what}: state dtype {amps.dtype} is not float32")
    if not amps.is_contiguous():
        raise ValueError(f"{what}: the state must be contiguous")
    hi = _rows_of(amps, rows, what)
    k = _check_op(op, what)
    _check_out(amps, out, what)
    dst = amps if out is None else out
    if amps.data_ptr() % 16 or dst.data_ptr() % 16:
        raise ValueError(f"{what}: the kernel moves 16-byte vectors; the "
                         "state and out must start on 16 bytes")
    stream = torch.cuda.current_stream(amps.device).cuda_stream
    build.raise_on(_lib().qt_stream_pass(amps.data_ptr(), dst.data_ptr(),
                                         hi, rows, k, scale, stream), what)
    LAUNCHES["P1"] += 1
    # written through the pointer: bump the tensor's version
    torch.autograd.graph.increment_version(dst)
    return dst


def reset_launch_counts() -> None:
    """Set the kernel's launch count to 0."""
    LAUNCHES.update(P1=0)
