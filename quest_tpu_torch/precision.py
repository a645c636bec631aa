"""Precision configuration for quest_tpu_torch.

Runtime analogue of the reference's compile-time precision switch
(``QuEST/include/QuEST_precision.h``): new registers take the currently
configured dtype.  The default is single precision (float32), and
``set_precision(2)`` selects float64.  Both dtypes run through the
hand-written CUDA kernels: the card computes float64 natively.
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
    quest_prec: int = 1  # 1 = single (float32), 2 = double (float64)


_state = _PrecisionState()


def set_precision(quest_prec: int) -> None:
    """Set the working precision: 1 = single (float32), 2 = double
    (float64).  Quad precision (4) keeps float64 storage, as in the
    reference package, but its compensated reductions are not ported yet,
    so 4 is rejected here."""
    if quest_prec not in (1, 2):
        raise ValueError("quest_prec must be 1 (single) or 2 (double)")
    _state.quest_prec = quest_prec


def get_precision() -> int:
    return _state.quest_prec


def real_dtype() -> torch.dtype:
    return torch.float64 if _state.quest_prec == 2 else torch.float32


def complex_dtype() -> torch.dtype:
    return torch.complex128 if _state.quest_prec == 2 else torch.complex64


def real_eps() -> float:
    """Reported epsilon, matching QuEST_precision.h REAL_EPS."""
    return _REAL_EPS[_state.quest_prec]


def validation_eps() -> float:
    """Tolerance for unitarity checks of user-supplied matrices."""
    return _REAL_EPS[min(_state.quest_prec, 2)]


# Reference cap on amps per MPI message / full-state host gather
# (MPI_MAX_AMPS_IN_MSG, QuEST_precision.h:32,46: 2^29 amps single, 2^28
# double), applied where a whole state would be gathered to one host
# buffer (compareStates, reportStateToScreen).
_MAX_AMPS_IN_MSG = {1: 1 << 29, 2: 1 << 28}


def max_amps_in_msg() -> int:
    return _MAX_AMPS_IN_MSG[_state.quest_prec]
