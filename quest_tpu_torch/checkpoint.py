"""Register state files in the reference's CSV format.

``writeStateToFile`` writes one ``re, im`` line per amplitude after a
``#`` comment line; ``readStateFromFile`` reads such a file (blank and
``#`` lines skipped), as the reference's reportState and
initStateFromSingleFile do (QuEST_common.c:229-245, QuEST_cpu.c:1680-1729).
The files are the JAX package's, byte for byte for the same state, so
each package reads what the other writes.  The state moves between the
device and the file in chunks of 2^20 amplitudes.

The JAX package's ``saveQureg``/``loadQureg`` (an orbax checkpoint with
metadata) arrive with the resilience layer.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .qureg import Qureg

# amplitudes per chunk moved between the device and the file: 2^20
# float64 pairs = a 16 MB host buffer
_CHUNK = 1 << 20


def writeStateToFile(qureg: Qureg, filename: str) -> None:
    """Dump the amplitudes as reference-style CSV (QuEST_common.c:229-245),
    one ``repr(re), repr(im)`` line each, chunk by chunk."""
    amps = qureg.amps
    total = qureg.num_amps_total
    with open(filename, "w") as f:
        f.write("# quest_tpu state dump: re, im per amplitude\n")
        for start in range(0, total, _CHUNK):
            part = amps[:, start:start + _CHUNK].double().cpu().numpy()
            f.writelines(f"{float(re)!r}, {float(im)!r}\n"
                         for re, im in zip(part[0], part[1]))


def readStateFromFile(qureg: Qureg, filename: str) -> bool:
    """Load amplitudes from reference-style CSV; returns success
    (statevec_initStateFromSingleFile, QuEST_cpu.c:1680-1729).  The file
    streams chunk by chunk into a fresh tensor on the register's device,
    and the register is rebound only on full success: a missing,
    malformed, truncated or non-finite (NaN/Inf) file leaves the state
    untouched.  Lines beyond the register's size are ignored."""
    if not os.path.exists(filename):
        return False
    total = qureg.num_amps_total
    work = torch.zeros((2, total), dtype=qureg.dtype, device=qureg.device)
    buf = np.zeros((2, _CHUNK))
    fill = 0          # valid amps in buf
    written = 0       # amps copied to the device

    def flush():
        work[:, written:written + fill] = torch.from_numpy(
            buf[:, :fill]).to(device=qureg.device, dtype=qureg.dtype)

    try:
        with open(filename) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                if written + fill >= total:
                    break
                parts = line.split(",")
                re, im = float(parts[0]), float(parts[1])
                if not (math.isfinite(re) and math.isfinite(im)):
                    return False
                buf[0, fill], buf[1, fill] = re, im
                fill += 1
                if fill == _CHUNK:
                    flush()
                    written += fill
                    fill = 0
    except (ValueError, IndexError):
        return False  # a malformed line: the state stays as it was
    if fill:
        flush()
        written += fill
    if written < total:
        return False  # a truncated file
    qureg.amps = work
    return True
