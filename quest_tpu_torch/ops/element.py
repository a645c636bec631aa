"""Element access: single amplitudes, canonical blocks and ranges.

The counterpart of the JAX package's ``ops/element.py``.  There, getAmp-
and setAmps-class calls go through jitted dynamic slices of the canonical
(2, 2^(n-14), 128, 128) view, so that no call relays the whole state out
(an eager ``amps[:, index]`` on a canonically tiled XLA array copied it)
and a write is one dynamic_update_slice plus read-modify-write edge
tiles.  A PyTorch tensor has no tiled layout: every view of a contiguous
state is a free reshape, a read of one amplitude moves two numbers, and a
range write is one in-place slice assignment on the register's own
storage, as the reference's setAmps writes into its chunk in place
(QuEST_cpu.c setAmps).  The functions take the flat (2, 2^n) form or the
canonical view and keep the caller's shape.
"""

from __future__ import annotations

import numpy as np
import torch

from .fused import CLUSTER_DIM as DIM, CLUSTER_QUBITS as BLK_BITS

BLK = 1 << BLK_BITS  # amps per canonical block (one 128 x 128 tile pair)


def _flat(amps):
    """The state as its (2, N) view (no copy for a contiguous state)."""
    return amps.reshape(2, -1)


def get_amp_pair(amps, index: int):
    """(re, im) of amplitude ``index`` as a (2,) tensor on the state's
    device: one two-element read, whatever the view."""
    return _flat(amps)[:, int(index)]


def get_block_host(amps, b: int) -> np.ndarray:
    """Canonical block ``b`` (amplitudes [b 2^14, (b + 1) 2^14), fewer at
    the end of a smaller register) as a host (2, m) array."""
    flat = _flat(amps)
    lo = b * BLK
    return flat[:, lo:min(lo + BLK, flat.shape[1])].cpu().numpy()


def set_amp_range(amps, start: int, vals):
    """Overwrite amplitudes [start, start + m) with ``vals`` (2, m), host
    or tensor, in place; returns ``amps`` (the same tensor, its shape and
    storage unchanged)."""
    if not amps.is_contiguous():
        raise ValueError("set_amp_range writes in place: the state must be "
                         "contiguous")
    vals = torch.as_tensor(np.asarray(vals) if not torch.is_tensor(vals)
                           else vals)
    m = int(vals.shape[1])
    if m:
        _flat(amps)[:, start:start + m] = vals.to(dtype=amps.dtype,
                                                  device=amps.device)
    return amps

