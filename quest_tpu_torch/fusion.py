"""Gate fusion for the imperative API: batch gates, execute in few passes.

Inside a ``gateFusion(qureg)`` context, gates issued through the ordinary
imperative API (hadamard, controlledNot, unitary, ...) are BUFFERED
instead of executed, and drained through the circuit optimizer and the
planner (windowed, or paged under QT_PLANNER=paged) the moment anything
needs the amplitudes:

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
matrix-free index ops), dense runs (planned into window passes) and runs
of decoherence channels, and executes them in order on the register's
tensor.  On a density register a Kraus channel is buffered as its
superoperator, a dense gate on (T, T+n) (``capture_raw``); depolarising
and damping are buffered as ``ChannelItem``s (``capture_pair_channel``),
and a run of them drains through the K5 sweep kernel on the card
(``fused.apply_pair_channel_sweep``) or channel by channel
(``density.apply_pair_channel``).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import List

import numpy as np

from . import circuit as C
from . import optimizer as _opt
from .ops import cplx as _cplx
from .ops import density as _density
from .ops import fused as _fused

# largest dense gate (targets + controls) worth buffering; anything bigger
# executes eagerly
FUSION_MAX_GATE_QUBITS = 7


class FusionBuffer:
    __slots__ = ("gates",)

    def __init__(self):
        # C.Gate and ChannelItem entries, executed in order by the drain
        self.gates: List[object] = []


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


class ChannelItem:
    """A captured depolarise / damping channel, buffered between gate
    segments and run by the drain in call order.  ``prob`` is a run-time
    value: the plan of a drain does not depend on it."""

    __slots__ = ("kind", "target", "bra", "prob")

    def __init__(self, kind: str, target: int, bra: int, prob: float):
        self.kind = kind
        self.target = target       # ket bit position in the state vector
        self.bra = bra             # bra twin bit (target + numQubits)
        self.prob = float(prob)


def _plan_key(items, nloc: int, sweep_ok: bool, device=None):
    """Content key for an item list: the gate matrices' bytes, each
    channel's (kind, target, bra) (its probability is a run-time value),
    whether channel runs may sweep, and the knobs that change the plan:
    the planner (QT_PLANNER) and megawin grouping."""
    parts = []
    for it in items:
        if isinstance(it, ChannelItem):
            parts.append(("chan", it.kind, it.target, it.bra))
            continue
        m = it.mat
        if not isinstance(m, np.ndarray):
            return None
        parts.append((it.targets, m.dtype.str, m.shape, m.tobytes()))
    return (nloc, sweep_ok, C.resolve_planner(),
            _fused.megakernel_planning(device), tuple(parts))


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


def _split_items(items, nloc: int, sweep_ok: bool, device=None):
    """Items -> program: a tuple of ("perm", ops), ("plan", ops),
    ("chan", kind, t, b) and ("chansweep", ((kind, t, b), ...)) parts
    executed in order (channel probabilities are walked at run time).
    With ``sweep_ok``, a run of consecutive channels whose ket bits all
    lie below 14 on a register of 15 bits or more is one chansweep part
    (fused.apply_pair_channel_sweep)."""
    program = []
    seg: list = []
    chans: list = []

    def flush_gates():
        for kind, sub in _perm_runs(seg):
            if kind == "perm":
                ops = C.lower_permutation_run(sub, nloc)
                if ops:
                    program.append(("perm", tuple(ops)))
            else:
                program.append(("plan", tuple(C.plan_circuit(
                    list(sub), nloc, device=device))))
        seg.clear()

    def flush_chans():
        if not chans:
            return
        if (sweep_ok and nloc >= _fused.CLUSTER_QUBITS + 1
                and all(t < _fused.CLUSTER_QUBITS for _k, t, _b in chans)):
            program.append(("chansweep", tuple(chans)))
        else:
            program.extend(("chan", kind, t, b) for kind, t, b in chans)
        chans.clear()

    for it in items:
        if isinstance(it, ChannelItem):
            flush_gates()
            chans.append((it.kind, it.target, it.bra))
        else:
            flush_chans()
            seg.append(it)
    flush_chans()
    flush_gates()
    return tuple(program)


def _plan_optimized(items, num_qubits: int, device, sweep_ok: bool):
    """The program of an optimized item list (cached on its content)."""
    if not items:
        return ()
    key = _plan_key(items, num_qubits, sweep_ok, device)
    hit = _plan_cache.get(key) if key is not None else None
    if hit is not None:
        return hit
    program = _split_items(items, num_qubits, sweep_ok, device)
    if key is not None:
        if len(_plan_cache) >= _PLAN_CACHE_MAX:
            _plan_cache.pop(next(iter(_plan_cache)))
        _plan_cache[key] = program
    return program


def plan_items(items, num_qubits: int, device=None, sweep_ok: bool = False):
    """The program a drain of ``items`` on an n-qubit register on
    ``device`` executes: the optimized stream split into permutation,
    planned and channel parts (cached on the items' content).  A drain
    passes ``sweep_ok = fused.channel_sweep_enabled(state)``."""
    items, _stats = _opt.optimize_items(items, nloc=num_qubits)
    return _plan_optimized(items, num_qubits, device, sweep_ok)


def program_stats(program) -> dict:
    """circuit.stats summed over a program's planned parts, plus its
    channel parts: "chan" (one channel each) and "chansweep" (a run)."""
    total: dict = {}
    for part in program:
        if part[0] in ("chan", "chansweep"):
            total[part[0]] = total.get(part[0], 0) + 1
            continue
        for k, v in C.stats(part[1]).items():
            total[k] = total.get(k, 0) + v
    return total


def execute_program(amps, program, probs, num_qubits: int):
    """Run a program's parts in order; ``probs`` holds the probability of
    each of its channels, in order.  Returns the new state (a sweep
    overwrites a float32 state on the card in place)."""
    n = num_qubits
    pi = 0
    for part in program:
        if part[0] == "chansweep":
            entries = part[1]
            amps = _fused.apply_pair_channel_sweep(
                amps, entries, probs[pi:pi + len(entries)], num_bits=n)
            pi += len(entries)
        elif part[0] == "chan":
            _, kind, t, b = part
            amps = _density.apply_pair_channel(amps, kind, probs[pi], nn=n,
                                               t=t, b=b)
            pi += 1
        else:
            amps = C.execute_plan(amps, part[1], n)
    return amps


def _run(qureg, items) -> None:
    """Plan with the concrete gate matrices (so controlled gates Schmidt-
    decompose to their true rank), then execute the program on the
    register's tensor, with the channels' probabilities in stream
    order."""
    n = qureg.num_qubits_in_state_vec
    amps = qureg._amps
    items, _stats = _opt.optimize_items(items, nloc=n)
    program = _plan_optimized(items, n, qureg.device,
                              _fused.channel_sweep_enabled(amps))
    probs = tuple(it.prob for it in items if isinstance(it, ChannelItem))
    qureg._amps = execute_program(amps, program, probs, n)


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


def capture_raw(qureg, stacked, targets) -> bool:
    """Buffer a dense matrix on state-vector bit positions ``targets`` with
    no density-matrix twin: a decoherence channel's superoperator, which
    already acts on the combined (T, T+n) targets (QuEST_common.c:630-652),
    so it folds into the drain's planned passes like a gate."""
    if not _capturable(qureg, tuple(targets)):
        drain(qureg)
        return False
    qureg._fusion.gates.append(C.Gate(tuple(targets), stacked))
    return True


def capture_pair_channel(qureg, kind: str, target: int, prob) -> bool:
    """Buffer a depolarise / damping channel as a ChannelItem, run by the
    drain in call order between the gate segments (not as a superoperator
    fold: these channels have operator-Schmidt rank 4 across (t, t+n))."""
    sh = qureg.num_qubits_represented
    if not _capturable(qureg, (target, target + sh)):
        drain(qureg)
        return False
    qureg._fusion.gates.append(ChannelItem(kind, target, target + sh, prob))
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
