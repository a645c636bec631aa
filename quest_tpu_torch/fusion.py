"""Gate fusion for the imperative API: batch gates, execute in few passes.

Inside a ``gateFusion(qureg)`` context, gates issued through the ordinary
imperative API (hadamard, controlledNot, unitary, ...) are BUFFERED
instead of executed, and drained through the circuit optimizer and the
windowed planner the moment anything needs the amplitudes:

    with qt.gateFusion(q):
        for d in range(depth):
            for t in range(n):
                qt.unitary(q, t, u[d, t])
            for t in range(d % 2, n - 1, 2):
                qt.controlledNot(q, t, t + 1)
    p = qt.calcProbOfOutcome(q, n - 1, 0)      # any read drains

Semantics are identical to the unfused path: validation and QASM
recording happen per call, in call order, and any read of the state
drains the buffer first via the ``Qureg.amps`` property.  A drain splits
the optimized stream into runs of permutation gates (lowered to
matrix-free index ops) and dense runs (planned into window passes), and
executes them in order on the register's tensor.
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

import numpy as np

from . import circuit as C
from . import optimizer as _opt
from .ops import cplx as _cplx
from .ops import fused as _fused

# largest dense gate (targets + controls) worth buffering; anything bigger
# executes eagerly
FUSION_MAX_GATE_QUBITS = 7


class FusionBuffer:
    __slots__ = ("gates",)

    def __init__(self):
        self.gates: List[C.Gate] = []


def start_gate_fusion(qureg) -> None:
    """Begin buffering gates on ``qureg`` (idempotent)."""
    if qureg._fusion is None:
        qureg._fusion = FusionBuffer()


def stop_gate_fusion(qureg) -> None:
    """Drain any buffered gates and stop buffering.  If execution fails
    the buffer stays attached with its gates intact."""
    drain(qureg)
    qureg._fusion = None


def drain(qureg) -> None:
    """Execute buffered gates now (called from the Qureg.amps property).
    On failure the gates are restored to the buffer."""
    buf = qureg._fusion
    if buf is not None and buf.gates:
        gates, buf.gates = buf.gates, []
        try:
            _run(qureg, gates)
        except BaseException:
            buf.gates = gates + buf.gates
            raise


_PLAN_CACHE_MAX = 64
_plan_cache: dict = {}


def _plan_key(items, nloc: int, device=None):
    """Content key for an item list: the matrices' bytes plus the knob
    that changes the plan (megawin grouping)."""
    parts = []
    for it in items:
        m = it.mat
        if not isinstance(m, np.ndarray):
            return None
        parts.append((it.targets, m.dtype.str, m.shape, m.tobytes()))
    return (nloc, _fused.megakernel_planning(device), tuple(parts))


# minimum adjacent permutation-classified gates worth splitting out of a
# dense segment: a lone X between dense neighbours fuses better inside
# their window pass than as its own pass
_PERM_RUN_MIN = 2


def _perm_runs(seg):
    """Partition one gate segment into maximal runs of permutation gates
    and interleaved dense runs, in stream order:
    ``[("perm" | "dense", [gates...]), ...]``.  Runs shorter than
    _PERM_RUN_MIN are demoted to dense."""
    flags = [C.classify_permutation_gate(g.mat) is not None for g in seg]
    i = 0
    while i < len(seg):
        if flags[i]:
            j = i
            while j < len(seg) and flags[j]:
                j += 1
            if j - i < _PERM_RUN_MIN:
                for k in range(i, j):
                    flags[k] = False
            i = j
        else:
            i += 1
    runs: List[tuple] = []
    for flag, g in zip(flags, seg):
        kind = "perm" if flag else "dense"
        if runs and runs[-1][0] == kind:
            runs[-1][1].append(g)
        else:
            runs.append((kind, [g]))
    return runs


def _split_items(items, nloc: int, device=None):
    """Gate items -> program: a tuple of ("perm", ops) and ("plan", ops)
    parts executed in order."""
    program = []
    for kind, sub in _perm_runs(items):
        if kind == "perm":
            ops = C.lower_permutation_run(sub, nloc)
            if ops:
                program.append(("perm", tuple(ops)))
        else:
            program.append(("plan", tuple(C.plan_circuit(list(sub), nloc,
                                                         device=device))))
    return tuple(program)


def plan_items(items, num_qubits: int, device=None):
    """The program a drain of ``items`` on an n-qubit register on
    ``device`` executes: the optimized stream split into permutation and
    planned parts (cached on the items' content)."""
    items, _stats = _opt.optimize_items(items, nloc=num_qubits)
    if not items:
        return ()
    key = _plan_key(items, num_qubits, device)
    hit = _plan_cache.get(key) if key is not None else None
    if hit is not None:
        return hit
    program = _split_items(items, num_qubits, device)
    if key is not None:
        if len(_plan_cache) >= _PLAN_CACHE_MAX:
            _plan_cache.pop(next(iter(_plan_cache)))
        _plan_cache[key] = program
    return program


def program_stats(program) -> dict:
    """circuit.stats summed over a program's parts."""
    total: dict = {}
    for _kind, ops in program:
        for k, v in C.stats(ops).items():
            total[k] = total.get(k, 0) + v
    return total


def _run(qureg, items) -> None:
    """Plan with the concrete gate matrices (so controlled gates Schmidt-
    decompose to their true rank), then execute the program on the
    register's tensor."""
    n = qureg.num_qubits_in_state_vec
    program = plan_items(items, n, qureg.device)
    amps = qureg._amps
    for _kind, ops in program:
        amps = C.execute_plan(amps, ops, n)
    qureg._amps = amps


def _capturable(qureg, bits) -> bool:
    """Can a gate on qubit positions ``bits`` be buffered?"""
    return qureg._fusion is not None and len(tuple(bits)) <= \
        FUSION_MAX_GATE_QUBITS


def capture_unitary(qureg, stacked, targets, controls=(),
                    control_states=()) -> bool:
    """Buffer a dense gate (with the density-matrix conjugate twin,
    QuEST.c:181-183) if fusion is active and the gate qualifies; returns
    False to tell the caller to execute eagerly (after draining, so order
    is preserved)."""
    base_bits = tuple(targets) + tuple(controls)
    if not _capturable(qureg, base_bits):
        drain(qureg)
        return False
    mat = stacked
    if controls:
        mat = C.controlled_dense(stacked, len(controls), control_states)
    buf = qureg._fusion
    buf.gates.append(C.Gate(tuple(targets) + tuple(controls), mat))
    if qureg.is_density_matrix:
        sh = qureg.num_qubits_represented
        cmat = _cplx.conj(stacked)
        if controls:
            cmat = C.controlled_dense(cmat, len(controls), control_states)
        buf.gates.append(
            C.Gate(tuple(t + sh for t in targets)
                   + tuple(c + sh for c in controls), cmat))
    return True


_X = np.stack([np.array([[0.0, 1.0], [1.0, 0.0]]), np.zeros((2, 2))])


def capture_not(qureg, targets, controls=(), control_states=()) -> bool:
    """Buffer a (multi-controlled) multi-qubit NOT: uncontrolled targets
    become independent 1q X gates; controlled ones one dense gate."""
    if not controls:
        if qureg._fusion is None:
            return False
        sh = qureg.num_qubits_represented
        for t in targets:
            qureg._fusion.gates.append(C.Gate((t,), _X))
            if qureg.is_density_matrix:
                qureg._fusion.gates.append(C.Gate((t + sh,), _X))
        return True
    # size-check BEFORE densifying the 2^nt x 2^nt matrix
    if not _capturable(qureg, tuple(targets) + tuple(controls)):
        drain(qureg)
        return False
    d = 1 << len(targets)
    xr = np.zeros((d, d))
    for i in range(d):
        xr[i, i ^ (d - 1)] = 1.0
    mat = np.stack([xr, np.zeros((d, d))])
    return capture_unitary(qureg, mat, targets, controls, control_states)


def capture_diag(qureg, diag_stacked, targets, controls=(),
                 control_states=()) -> bool:
    """Buffer a diagonal gate as its dense matrix."""
    if not _capturable(qureg, tuple(targets) + tuple(controls)):
        drain(qureg)
        return False
    d = diag_stacked.shape[-1]
    mat = np.zeros((2, d, d), dtype=diag_stacked.dtype)
    mat[0][np.diag_indices(d)] = diag_stacked[0]
    mat[1][np.diag_indices(d)] = diag_stacked[1]
    return capture_unitary(qureg, mat, targets, controls, control_states)


@contextmanager
def gate_fusion(qureg):
    """Context manager: buffer imperative-API gates on ``qureg`` and
    execute them through the fused planner on exit (or the moment any
    operation needs the amplitudes).  Nesting-safe: an inner context
    reuses the outer buffer and leaves it active on exit."""
    created = qureg._fusion is None
    start_gate_fusion(qureg)
    try:
        yield qureg
    finally:
        if created:
            stop_gate_fusion(qureg)
