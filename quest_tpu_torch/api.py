"""Public API: registers, state initialisation and the unitary gates.

The QuEST camelCase surface (QuEST.h) of the ported slice.  Every gate
follows the reference's dispatch shape (QuEST.c:177-186): validate ->
buffer in the active ``gateFusion`` context, or apply eagerly to the ket
qubits -> on a density matrix, the conjugated twin on the bra qubits
(+numQubits shift) -> QASM record.  The register re-binds its amplitude
tensor after each eager operation.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import env as _env
from . import fusion as _fusion
from . import validation as V
from .ops import cplx as CX
from .ops import gatedefs as G
from .ops import kernels as K
from .qureg import Qureg

# ---------------------------------------------------------------------------
# Environment (QuEST.h:1851-1939)
# ---------------------------------------------------------------------------

createQuESTEnv = _env.create_quest_env
destroyQuESTEnv = _env.destroy_quest_env
syncQuESTEnv = _env.sync_quest_env
getEnvironmentString = _env.get_environment_string
seedQuEST = _env.seed_quest
seedQuESTDefault = _env.seed_quest_default
QuESTError = V.QuESTError


def reportQuESTEnv(env: _env.QuESTEnv) -> None:
    """Print execution-environment parameters (QuEST.h:1893)."""
    print(getEnvironmentString(env))


# ---------------------------------------------------------------------------
# Register lifecycle (QuEST.c:36-76)
# ---------------------------------------------------------------------------


def createQureg(numQubits: int, env: _env.QuESTEnv) -> Qureg:
    """Create a state-vector register of numQubits qubits in |0...0>
    (QuEST.h:529)."""
    V.validate_num_qubits(numQubits, "createQureg")
    q = Qureg(numQubits, env, is_density_matrix=False)
    q.amps = K.init_zero_state(q.num_amps_total, q.dtype, q.device)
    return q


def createDensityQureg(numQubits: int, env: _env.QuESTEnv) -> Qureg:
    """Create a density-matrix register (a state-vector of 2N qubits) in
    |0><0| (QuEST.h:623)."""
    V.validate_num_qubits(numQubits, "createDensityQureg")
    q = Qureg(numQubits, env, is_density_matrix=True)
    q.amps = K.init_classical_density(numQubits, 0, q.dtype, q.device)
    return q


def createCloneQureg(qureg: Qureg, env: _env.QuESTEnv) -> Qureg:
    """Create a new register cloning an existing one (QuEST.h:644)."""
    q = Qureg(qureg.num_qubits_represented, env, qureg.is_density_matrix)
    q.amps = qureg.amps.to(device=q.device, dtype=q.dtype, copy=True)
    return q


def destroyQureg(qureg: Qureg, env: Optional[_env.QuESTEnv] = None) -> None:
    """Free a register's amplitude storage (QuEST.h:666)."""
    qureg._fusion = None
    qureg.amps = None


def getNumQubits(qureg: Qureg) -> int:
    return qureg.num_qubits_represented


def getNumAmps(qureg: Qureg) -> int:
    V.validate_state_vector(qureg, "getNumAmps")
    return qureg.num_amps_total


# ---------------------------------------------------------------------------
# State initialisation (QuEST.h:1361-1559)
# ---------------------------------------------------------------------------


def initBlankState(qureg: Qureg) -> None:
    """Set all amplitudes to zero (QuEST.h:1361)."""
    qureg.amps = K.init_blank_state(qureg.num_amps_total, qureg.dtype,
                                    qureg.device)


def initZeroState(qureg: Qureg) -> None:
    """Set the register to |0...0> (QuEST.h:1375)."""
    if qureg.is_density_matrix:
        qureg.amps = K.init_classical_density(
            qureg.num_qubits_represented, 0, qureg.dtype, qureg.device)
    else:
        qureg.amps = K.init_zero_state(qureg.num_amps_total, qureg.dtype,
                                       qureg.device)
    qureg.qasm_log.init_zero()


def initPlusState(qureg: Qureg) -> None:
    """Set the register to |+>^n (QuEST.h:1394)."""
    if qureg.is_density_matrix:
        qureg.amps = K.init_plus_density(qureg.num_qubits_represented,
                                         qureg.dtype, qureg.device)
    else:
        qureg.amps = K.init_plus_state(qureg.num_amps_total, qureg.dtype,
                                       qureg.device)


def initClassicalState(qureg: Qureg, stateInd: int) -> None:
    """Set the register to a computational basis state (QuEST.h:1431)."""
    V.validate_state_index(qureg, stateInd, "initClassicalState")
    if qureg.is_density_matrix:
        qureg.amps = K.init_classical_density(
            qureg.num_qubits_represented, stateInd, qureg.dtype, qureg.device)
    else:
        qureg.amps = K.init_classical_state(
            qureg.num_amps_total, stateInd, qureg.dtype, qureg.device)


def initPureState(qureg: Qureg, pure: Qureg) -> None:
    """Initialise a register (or rho = |psi><psi|) from a pure state
    (QuEST.h:1451)."""
    V.validate_state_vector(pure, "initPureState")
    V.validate_matching_qureg_dims(qureg, pure, "initPureState")
    if qureg.is_density_matrix:
        qureg.amps = K.init_pure_density(pure.amps).to(qureg.dtype)
    else:
        qureg.amps = pure.amps.clone()


def initDebugState(qureg: Qureg) -> None:
    """amp_k = (2k mod 10)/10 + i(2k+1 mod 10)/10 (QuEST.h:1463)."""
    qureg.amps = K.init_debug_state(qureg.num_amps_total, qureg.dtype,
                                    qureg.device)


def setAmps(qureg: Qureg, startInd: int, reals, imags, numAmps: int) -> None:
    """Overwrite a contiguous range of amplitudes (QuEST.h:1537)."""
    V.validate_state_vector(qureg, "setAmps")
    V.validate_num_amps(qureg, startInd, numAmps, "setAmps")
    re = np.asarray(reals, dtype=np.float64).ravel()[:numAmps]
    im = np.asarray(imags, dtype=np.float64).ravel()[:numAmps]
    if re.size != numAmps or im.size != numAmps:
        raise V.QuESTError("setAmps: Incorrect number of amplitudes.")
    V.validate_finite(re, "setAmps")
    V.validate_finite(im, "setAmps")
    amps = qureg.amps.clone()
    amps[:, startInd:startInd + numAmps] = torch.as_tensor(
        np.stack([re, im]), dtype=qureg.dtype, device=qureg.device)
    qureg.amps = amps


# ---------------------------------------------------------------------------
# Dispatch helpers (QuEST.c:177-346 twin-op pattern)
# ---------------------------------------------------------------------------


def _sv_n(qureg: Qureg) -> int:
    return qureg.num_qubits_in_state_vec


def _shift(qureg: Qureg) -> int:
    return qureg.num_qubits_represented


def _twins(qureg, targets, controls):
    """(targets, controls, conj) for the ket op and, on a density matrix,
    the conjugated bra twin."""
    yield targets, controls, False
    if qureg.is_density_matrix:
        sh = _shift(qureg)
        yield (tuple(t + sh for t in targets),
               tuple(c + sh for c in controls), True)


def _apply_unitary(qureg, matrix, targets, controls=(), control_states=()):
    """A dense gate: buffered inside a gateFusion context, else applied
    eagerly (ket, then the conjugated bra twin on a density matrix)."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    control_states = tuple(int(s) for s in control_states)
    stacked = CX.soa(matrix)
    if _fusion.capture_unitary(qureg, stacked, targets, controls,
                               control_states):
        return
    for t, c, conj in _twins(qureg, targets, controls):
        m = CX.conj(stacked) if conj else stacked
        qureg.amps = K.apply_matrix(qureg.amps, m, num_qubits=_sv_n(qureg),
                                    targets=t, controls=c,
                                    control_states=control_states)


def _apply_diag(qureg, diag, targets, controls=(), control_states=()):
    """A diagonal gate (no amplitude pairing)."""
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    control_states = tuple(int(s) for s in control_states)
    stacked = CX.soa(diag)
    if _fusion.capture_diag(qureg, stacked, targets, controls,
                            control_states):
        return
    for t, c, conj in _twins(qureg, targets, controls):
        d = CX.conj(stacked) if conj else stacked
        qureg.amps = K.apply_diagonal(qureg.amps, d, num_qubits=_sv_n(qureg),
                                      targets=t, controls=c,
                                      control_states=control_states)


def _apply_not(qureg, targets, controls, control_states=()):
    """NOTs are pure index-bit flips."""
    if _fusion.capture_not(qureg, targets, controls, control_states):
        return
    for t, c, _conj in _twins(qureg, tuple(targets), tuple(controls)):
        qureg.amps = K.apply_multi_qubit_not(
            qureg.amps, num_qubits=_sv_n(qureg), targets=t, controls=c,
            control_states=control_states)


# ---------------------------------------------------------------------------
# Unitaries (QuEST.h:1595-4744)
# ---------------------------------------------------------------------------


def phaseShift(qureg: Qureg, targetQubit: int, angle: float) -> None:
    """Shift the phase of the |1> amplitude of one qubit (QuEST.h:1595)."""
    V.validate_target(qureg, targetQubit, "phaseShift")
    _apply_diag(qureg, G.phase_shift_diag(angle), (targetQubit,))
    qureg.qasm_log.phase_shift(float(angle), (), targetQubit)


def controlledPhaseShift(qureg: Qureg, idQubit1: int, idQubit2: int,
                         angle: float) -> None:
    """Controlled phase shift by the given angle (QuEST.h:1640)."""
    V.validate_control_target(qureg, idQubit1, idQubit2,
                              "controlledPhaseShift")
    _apply_diag(qureg, G.phase_shift_diag(angle), (idQubit2,), (idQubit1,))
    qureg.qasm_log.phase_shift(float(angle), (idQubit1,), idQubit2)


def controlledPhaseFlip(qureg: Qureg, idQubit1: int, idQubit2: int) -> None:
    """Controlled phase flip (controlled-Z) (QuEST.h:1723)."""
    V.validate_control_target(qureg, idQubit1, idQubit2,
                              "controlledPhaseFlip")
    _apply_diag(qureg, G.Z_DIAG, (idQubit2,), (idQubit1,))
    qureg.qasm_log.gate("z", (idQubit1,), idQubit2)


def sGate(qureg: Qureg, targetQubit: int) -> None:
    """Apply the S (phase) gate (QuEST.h:1801)."""
    V.validate_target(qureg, targetQubit, "sGate")
    _apply_diag(qureg, G.S_GATE_DIAG, (targetQubit,))
    qureg.qasm_log.gate("s", (), targetQubit)


def tGate(qureg: Qureg, targetQubit: int) -> None:
    """Apply the T (pi/8) gate (QuEST.h:1834)."""
    V.validate_target(qureg, targetQubit, "tGate")
    _apply_diag(qureg, G.T_GATE_DIAG, (targetQubit,))
    qureg.qasm_log.gate("t", (), targetQubit)


def compactUnitary(qureg: Qureg, targetQubit: int, alpha, beta) -> None:
    """[[alpha, -conj(beta)], [beta, conj(alpha)]] (QuEST.h:2141)."""
    V.validate_target(qureg, targetQubit, "compactUnitary")
    alpha, beta = complex(alpha), complex(beta)
    V.validate_unitary_complex_pair(alpha, beta, "compactUnitary")
    m = G.compact_unitary_matrix(alpha, beta)
    _apply_unitary(qureg, m, (targetQubit,))
    qureg.qasm_log.unitary_2x2(m, (), targetQubit)


def unitary(qureg: Qureg, targetQubit: int, u) -> None:
    """Arbitrary single-qubit unitary (QuEST.h:2182)."""
    V.validate_target(qureg, targetQubit, "unitary")
    V.validate_unitary(u, 1, "unitary")
    _apply_unitary(qureg, u, (targetQubit,))
    qureg.qasm_log.unitary_2x2(np.asarray(u, complex), (), targetQubit)


def rotateX(qureg: Qureg, rotQubit: int, angle: float) -> None:
    V.validate_target(qureg, rotQubit, "rotateX")
    _apply_unitary(qureg, G.rotate_x_matrix(angle), (rotQubit,))
    qureg.qasm_log.gate("Rx", (), rotQubit, [float(angle)])


def rotateY(qureg: Qureg, rotQubit: int, angle: float) -> None:
    V.validate_target(qureg, rotQubit, "rotateY")
    _apply_unitary(qureg, G.rotate_y_matrix(angle), (rotQubit,))
    qureg.qasm_log.gate("Ry", (), rotQubit, [float(angle)])


def rotateZ(qureg: Qureg, rotQubit: int, angle: float) -> None:
    V.validate_target(qureg, rotQubit, "rotateZ")
    _apply_diag(qureg, G.rotate_z_diag(angle), (rotQubit,))
    qureg.qasm_log.gate("Rz", (), rotQubit, [float(angle)])


def controlledRotateX(qureg, controlQubit, targetQubit, angle) -> None:
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledRotateX")
    _apply_unitary(qureg, G.rotate_x_matrix(angle), (targetQubit,),
                   (controlQubit,))
    qureg.qasm_log.gate("Rx", (controlQubit,), targetQubit, [float(angle)])


def controlledRotateY(qureg, controlQubit, targetQubit, angle) -> None:
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledRotateY")
    _apply_unitary(qureg, G.rotate_y_matrix(angle), (targetQubit,),
                   (controlQubit,))
    qureg.qasm_log.gate("Ry", (controlQubit,), targetQubit, [float(angle)])


def controlledRotateZ(qureg, controlQubit, targetQubit, angle) -> None:
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledRotateZ")
    _apply_diag(qureg, G.rotate_z_diag(angle), (targetQubit,),
                (controlQubit,))
    qureg.qasm_log.gate("Rz", (controlQubit,), targetQubit, [float(angle)])


def controlledCompactUnitary(qureg, controlQubit, targetQubit, alpha,
                             beta) -> None:
    """Controlled compact unitary (QuEST.h:2537)."""
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledCompactUnitary")
    alpha, beta = complex(alpha), complex(beta)
    V.validate_unitary_complex_pair(alpha, beta, "controlledCompactUnitary")
    m = G.compact_unitary_matrix(alpha, beta)
    _apply_unitary(qureg, m, (targetQubit,), (controlQubit,))
    qureg.qasm_log.unitary_2x2(m, (controlQubit,), targetQubit)


def controlledUnitary(qureg, controlQubit, targetQubit, u) -> None:
    """Controlled arbitrary single-qubit unitary (QuEST.h:2588)."""
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledUnitary")
    V.validate_unitary(u, 1, "controlledUnitary")
    _apply_unitary(qureg, u, (targetQubit,), (controlQubit,))
    qureg.qasm_log.unitary_2x2(np.asarray(u, complex), (controlQubit,),
                               targetQubit)


def multiControlledUnitary(qureg, controlQubits, targetQubit, u) -> None:
    """Multi-controlled arbitrary single-qubit unitary (QuEST.h:2652)."""
    controls, target = [int(c) for c in controlQubits], int(targetQubit)
    V.validate_multi_controls_target(qureg, controls, target,
                                     "multiControlledUnitary")
    V.validate_unitary(u, 1, "multiControlledUnitary")
    _apply_unitary(qureg, u, (target,), tuple(controls))
    qureg.qasm_log.unitary_2x2(np.asarray(u, complex), tuple(controls),
                               target)


def multiStateControlledUnitary(qureg, controlQubits, controlStates,
                                targetQubit, u) -> None:
    """Controlled unitary with per-control 0/1 condition states
    (QuEST.h:3877)."""
    controls = [int(c) for c in controlQubits]
    states = [int(s) for s in controlStates]
    V.validate_multi_controls_target(qureg, controls, targetQubit,
                                     "multiStateControlledUnitary")
    V.validate_control_states(controls, states,
                              "multiStateControlledUnitary")
    V.validate_unitary(u, 1, "multiStateControlledUnitary")
    _apply_unitary(qureg, u, (targetQubit,), tuple(controls), tuple(states))
    qureg.qasm_log.unitary_2x2(np.asarray(u, complex), tuple(controls),
                               targetQubit, states)


def pauliX(qureg: Qureg, targetQubit: int) -> None:
    """Apply Pauli-X (QuEST.h:2689)."""
    V.validate_target(qureg, targetQubit, "pauliX")
    _apply_not(qureg, (targetQubit,), ())
    qureg.qasm_log.gate("x", (), targetQubit)


def pauliY(qureg: Qureg, targetQubit: int) -> None:
    """Apply Pauli-Y (QuEST.h:2724)."""
    V.validate_target(qureg, targetQubit, "pauliY")
    _apply_unitary(qureg, G.PAULI_Y, (targetQubit,))
    qureg.qasm_log.gate("y", (), targetQubit)


def pauliZ(qureg: Qureg, targetQubit: int) -> None:
    """Apply Pauli-Z (QuEST.h:2762)."""
    V.validate_target(qureg, targetQubit, "pauliZ")
    _apply_diag(qureg, G.Z_DIAG, (targetQubit,))
    qureg.qasm_log.gate("z", (), targetQubit)


def hadamard(qureg: Qureg, targetQubit: int) -> None:
    """Apply the Hadamard gate (QuEST.h:2794)."""
    V.validate_target(qureg, targetQubit, "hadamard")
    _apply_unitary(qureg, G.HADAMARD, (targetQubit,))
    qureg.qasm_log.gate("h", (), targetQubit)


def controlledNot(qureg: Qureg, controlQubit: int, targetQubit: int) -> None:
    """Controlled Pauli-X (CNOT) (QuEST.h:2838)."""
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledNot")
    _apply_not(qureg, (targetQubit,), (controlQubit,))
    qureg.qasm_log.gate("x", (controlQubit,), targetQubit)


def controlledPauliY(qureg: Qureg, controlQubit: int,
                     targetQubit: int) -> None:
    """Controlled Pauli-Y (QuEST.h:3013)."""
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledPauliY")
    _apply_unitary(qureg, G.PAULI_Y, (targetQubit,), (controlQubit,))
    qureg.qasm_log.gate("y", (controlQubit,), targetQubit)


def multiQubitNot(qureg: Qureg, targs: Sequence[int]) -> None:
    """Pauli-X on several target qubits at once (QuEST.h:2971)."""
    targets = [int(t) for t in targs]
    V.validate_multi_targets(qureg, targets, "multiQubitNot")
    _apply_not(qureg, tuple(targets), ())
    for t in targets:
        qureg.qasm_log.gate("x", (), t)


def multiControlledMultiQubitNot(qureg, ctrls, targs) -> None:
    """Multi-controlled multi-target Pauli-X (QuEST.h:2914)."""
    controls, targets = [int(c) for c in ctrls], [int(t) for t in targs]
    V.validate_multi_controls_targets(qureg, controls, targets,
                                      "multiControlledMultiQubitNot")
    _apply_not(qureg, tuple(targets), tuple(controls))
    for t in targets:
        qureg.qasm_log.gate("x", tuple(controls), t)


_SWAP_SOA = np.stack([
    np.array([[1.0, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]]),
    np.zeros((4, 4)),
])


def swapGate(qureg: Qureg, qubit1: int, qubit2: int) -> None:
    """Swap two qubits' amplitudes (QuEST.h:3768): buffered as a SWAP
    matrix under fusion, else one qubit relabel (covering the bra twin)."""
    V.validate_unique_targets(qureg, qubit1, qubit2, "swapGate")
    if _fusion.capture_unitary(qureg, _SWAP_SOA, (qubit1, qubit2)):
        qureg.qasm_log.gate("swap", (qubit1,), qubit2)
        return
    n = _sv_n(qureg)
    perm = list(range(n))
    for t, _c, _conj in _twins(qureg, (qubit1, qubit2), ()):
        perm[t[0]], perm[t[1]] = perm[t[1]], perm[t[0]]
    qureg.amps = K.permute_qubits(qureg.amps, num_qubits=n, perm=tuple(perm))
    qureg.qasm_log.gate("swap", (qubit1,), qubit2)


def sqrtSwapGate(qureg: Qureg, qb1: int, qb2: int) -> None:
    """Apply the square-root-of-SWAP gate (QuEST.h:3816)."""
    V.validate_unique_targets(qureg, qb1, qb2, "sqrtSwapGate")
    _apply_unitary(qureg, G.SQRT_SWAP, (qb1, qb2))
    qureg.qasm_log.gate("sqrtswap", (qb1,), qb2)


def twoQubitUnitary(qureg: Qureg, targetQubit1: int, targetQubit2: int,
                    u) -> None:
    """Arbitrary two-qubit unitary (QuEST.h:4353)."""
    V.validate_unique_targets(qureg, targetQubit1, targetQubit2,
                              "twoQubitUnitary")
    V.validate_unitary(u, 2, "twoQubitUnitary")
    _apply_unitary(qureg, u, (targetQubit1, targetQubit2))
    qureg.qasm_log.comment("twoQubitUnitary applied")


def controlledTwoQubitUnitary(qureg, controlQubit, targetQubit1,
                              targetQubit2, u) -> None:
    """Controlled arbitrary two-qubit unitary (QuEST.h:4420)."""
    V.validate_multi_controls_targets(
        qureg, [controlQubit], [targetQubit1, targetQubit2],
        "controlledTwoQubitUnitary")
    V.validate_unitary(u, 2, "controlledTwoQubitUnitary")
    _apply_unitary(qureg, u, (targetQubit1, targetQubit2), (controlQubit,))
    qureg.qasm_log.comment("controlledTwoQubitUnitary applied")


def multiControlledTwoQubitUnitary(qureg, controlQubits, targetQubit1,
                                   targetQubit2, u) -> None:
    """Multi-controlled arbitrary two-qubit unitary (QuEST.h:4499)."""
    controls = [int(c) for c in controlQubits]
    V.validate_multi_controls_targets(
        qureg, controls, [targetQubit1, targetQubit2],
        "multiControlledTwoQubitUnitary")
    V.validate_unitary(u, 2, "multiControlledTwoQubitUnitary")
    _apply_unitary(qureg, u, (targetQubit1, targetQubit2), tuple(controls))
    qureg.qasm_log.comment("multiControlledTwoQubitUnitary applied")


def multiQubitUnitary(qureg: Qureg, targs: Sequence[int], u) -> None:
    """Arbitrary unitary on N target qubits (QuEST.h:4582)."""
    targets = [int(t) for t in targs]
    V.validate_multi_targets(qureg, targets, "multiQubitUnitary")
    V.validate_unitary(u, len(targets), "multiQubitUnitary")
    _apply_unitary(qureg, u, tuple(targets))
    qureg.qasm_log.comment("multiQubitUnitary applied")


def controlledMultiQubitUnitary(qureg, ctrl, targs, u) -> None:
    """Controlled arbitrary multi-qubit unitary (QuEST.h:4655)."""
    targets = [int(t) for t in targs]
    V.validate_multi_controls_targets(qureg, [ctrl], targets,
                                      "controlledMultiQubitUnitary")
    V.validate_unitary(u, len(targets), "controlledMultiQubitUnitary")
    _apply_unitary(qureg, u, tuple(targets), (ctrl,))
    qureg.qasm_log.comment("controlledMultiQubitUnitary applied")


def multiControlledMultiQubitUnitary(qureg, ctrls, targs, u) -> None:
    """Multi-controlled arbitrary multi-qubit unitary (QuEST.h:4744)."""
    controls, targets = [int(c) for c in ctrls], [int(t) for t in targs]
    V.validate_multi_controls_targets(qureg, controls, targets,
                                      "multiControlledMultiQubitUnitary")
    V.validate_unitary(u, len(targets), "multiControlledMultiQubitUnitary")
    _apply_unitary(qureg, u, tuple(targets), tuple(controls))
    qureg.qasm_log.comment("multiControlledMultiQubitUnitary applied")
