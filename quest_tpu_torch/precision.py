"""Precision configuration for quest_tpu_torch.

Runtime analogue of the reference's compile-time precision switch
(``QuEST/include/QuEST_precision.h``): new registers take the currently
configured dtype.  The default is single precision (float32),
``set_precision(2)`` selects float64 and ``set_precision(4)`` quad: float64
storage with the reductions where extended precision is observable
accumulated in double-double (``ops/calculations.py`` ``quad_sum``).  Both
dtypes run through the hand-written CUDA kernels: the card computes
float64 natively.
"""

from __future__ import annotations

import dataclasses

import torch

# Reference epsilon per precision (QuEST_precision.h:28-68): 1e-5 single,
# 1e-13 double, 1e-14 quad.
_REAL_EPS = {1: 1e-5, 2: 1e-13, 4: 1e-14}

# Reference cap on qubits in applyMultiVarPhaseFunc-style register lists
# (QuEST_precision.h:72).
MAX_NUM_REGS_APPLY_ARBITRARY_PHASE = 100


@dataclasses.dataclass
class _PrecisionState:
    quest_prec: int = 1  # 1 = single (float32), 2 = double, 4 = quad


_state = _PrecisionState()


def set_precision(quest_prec: int) -> None:
    """Set the working precision: 1 = single (float32), 2 = double
    (float64), 4 = quad (QuEST_PREC=4, QuEST_precision.h:55-68).

    Quad keeps float64 storage, as the JAX package does (no accelerator
    has a float128 type, and the reference refuses quad on its GPU
    backend).  What 4 changes: ``real_eps`` tightens to 1e-14 (user
    matrices are still validated at the float64 tolerance,
    ``validation_eps``), the message cap drops to 2^27 amplitudes, and
    every scalar reduction where extended precision is observable
    (total probability, inner products, purity, fidelity, Hilbert-Schmidt
    distance, diagonal and Pauli-sum expectations, outcome probabilities)
    accumulates in double-double (``ops/calculations.py``)."""
    if quest_prec not in (1, 2, 4):
        raise ValueError(
            "quest_prec must be 1 (single), 2 (double) or 4 (quad)")
    _state.quest_prec = quest_prec


def get_precision() -> int:
    return _state.quest_prec


def real_dtype() -> torch.dtype:
    return torch.float64 if _state.quest_prec in (2, 4) else torch.float32


def complex_dtype() -> torch.dtype:
    return (torch.complex128 if _state.quest_prec in (2, 4)
            else torch.complex64)


def real_eps() -> float:
    """Reported epsilon, matching QuEST_precision.h REAL_EPS."""
    return _REAL_EPS[_state.quest_prec]


def validation_eps() -> float:
    """Tolerance for unitarity checks of user-supplied matrices: under
    quad it stays at the float64 value, since the checks run in float64
    (the JAX package's choice)."""
    return _REAL_EPS[min(_state.quest_prec, 2)]


# Reference cap on amps per MPI message / full-state host gather
# (MPI_MAX_AMPS_IN_MSG, QuEST_precision.h:32,46,61: 2^29 amps single,
# 2^28 double, 2^27 quad), applied where a whole state would be gathered
# to one host buffer (compareStates, reportStateToScreen).
_MAX_AMPS_IN_MSG = {1: 1 << 29, 2: 1 << 28, 4: 1 << 27}


def max_amps_in_msg() -> int:
    return _MAX_AMPS_IN_MSG[_state.quest_prec]
