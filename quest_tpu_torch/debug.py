"""Debug and test-support API: the reference's QuEST_debug.h surface.

Single-qubit classical initialisation, state-file loading and amplitude-
wise state comparison (QuEST/src/QuEST_debug.h), as the JAX package's
``debug.py`` has them.  ``initDebugState`` and ``setDensityAmps`` live in
the main API (api.py), as in the reference.
"""

from __future__ import annotations

import math

import torch

from . import precision
from . import validation as V
from .checkpoint import readStateFromFile
from .env import QuESTEnv
from .parallel.mesh import ShardedAmps
from .parallel.sharded import compare
from .qureg import Qureg


def initStateOfSingleQubit(qureg: Qureg, qubitId: int, outcome: int) -> None:
    """Uniform superposition over every basis state whose ``qubitId`` bit
    equals ``outcome`` (statevec_initStateOfSingleQubit, QuEST_cpu.c:
    normFactor 1/sqrt(2^n / 2))."""
    V.validate_target(qureg, qubitId, "initStateOfSingleQubit")
    V.validate_outcome(outcome, "initStateOfSingleQubit")
    dim = qureg.num_amps_total
    norm = 1.0 / math.sqrt(dim / 2.0)
    idx = torch.arange(dim, device=qureg.device)
    amps = torch.zeros((2, dim), dtype=qureg.dtype, device=qureg.device)
    amps[0] = (((idx >> int(qubitId)) & 1) == int(outcome)).to(
        qureg.dtype) * norm
    qureg.amps = amps


def initStateFromSingleFile(qureg: Qureg, filename: str,
                            env: QuESTEnv | None = None) -> bool:
    """Load amplitudes from a reference-format CSV file; returns success
    (statevec_initStateFromSingleFile, QuEST_cpu.c:1680-1729)."""
    return readStateFromFile(qureg, filename)


def guard_host_gather(qureg: Qureg, func: str) -> None:
    """Refuse to gather a whole state into one host buffer beyond the
    reference's message cap (MPI_MAX_AMPS_IN_MSG; its toQVector guard,
    utilities.cpp:1073-1074)."""
    cap = precision.max_amps_in_msg()
    if qureg.num_amps_total > cap:
        raise V.QuESTError(
            f"{func}: State has too many amplitudes "
            f"({qureg.num_amps_total} > {cap}) to gather to a single host "
            "buffer; use getAmp/reportState per chunk instead.")


def compareStates(qureg1: Qureg, qureg2: Qureg, precision: float) -> bool:
    """|re1 - re2| and |im1 - im2| <= precision on every amplitude
    (statevec_compareStates, QuEST_cpu.c), compared on the device: no
    host gather, so no message cap (shard by shard on a sharded
    register)."""
    if qureg1.num_qubits_in_state_vec != qureg2.num_qubits_in_state_vec:
        return False
    a = qureg1.amps
    if isinstance(a, ShardedAmps):
        return compare(a, qureg2.amps, precision)
    b = qureg2.amps.to(device=qureg1.device, dtype=qureg1.dtype)
    return bool(torch.all(torch.abs(qureg1.amps - b) <= precision))
