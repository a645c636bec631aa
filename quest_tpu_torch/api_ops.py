"""Public API, part 2: amplitude reads, measurement, calculations,
decoherence channels, weighted sums and raw matrices (apply*), Pauli sums
and Trotter circuits, diagonal operators and phase functions, the quantum
Fourier transform, the circuit optimizer's mode, QASM recording.

Continues quest_tpu_torch.api (same conventions).  Reference parity:
QuEST.c calc* / get* / apply* functions.  Every read drains pending fused
gates through ``Qureg.amps`` first.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from . import circuit as CIRC
from . import fusion
from . import optimizer as _optimizer
from . import validation as V
from .api import PAULI_I, _shift, _sv_n, hadamard, multiRotatePauli, swapGate
from .ops import calculations as C
from .ops import cplx as CX
from .ops import density as D
from .ops import element as E
from .ops import gatedefs as G
from .ops import kernels as K
from .ops import measurement as M
from .ops import paulis as P
from .ops import phasefunc as PF
from .precision import get_precision, real_eps
from .qureg import DiagonalOp, PauliHamil, Qureg
from .rng import GLOBAL_RNG


def _quad() -> bool:
    """Precision 4: route reductions through double-double accumulation."""
    return get_precision() == 4


def _refuse_bank(qureg, what: str) -> None:
    """A BatchedQureg bank measures through batch.measureBatched, which
    draws from the per-element key streams."""
    if getattr(qureg, "batch_size", 0):
        raise V.QuESTError(
            f"{what}: the register is a BatchedQureg bank — use "
            "quest_tpu_torch.batch.measureBatched, which draws from the "
            "per-element key streams")


def getAmp(qureg: Qureg, index: int) -> complex:
    """Fetch one complex amplitude (QuEST.h:1987)."""
    V.validate_state_vector(qureg, "getAmp")
    V.validate_num_amps(qureg, index, 1, "getAmp")
    pair = E.get_amp_pair(qureg.amps, int(index)).cpu()
    return complex(float(pair[0]), float(pair[1]))


def getRealAmp(qureg: Qureg, index: int) -> float:
    """Fetch the real part of one amplitude (QuEST.h:2008)."""
    return getAmp(qureg, index).real


def getImagAmp(qureg: Qureg, index: int) -> float:
    """Fetch the imaginary part of one amplitude (QuEST.h:2029)."""
    return getAmp(qureg, index).imag


def getProbAmp(qureg: Qureg, index: int) -> float:
    """|amp|^2 of one amplitude (QuEST.h:2050)."""
    a = getAmp(qureg, index)
    return a.real * a.real + a.imag * a.imag


def getDensityAmp(qureg: Qureg, row: int, col: int) -> complex:
    """One density-matrix element rho[row, col] (QuEST.h:2072)."""
    V.validate_density_matrix(qureg, "getDensityAmp")
    dim = 1 << qureg.num_qubits_represented
    if not (0 <= row < dim and 0 <= col < dim):
        raise V.QuESTError("getDensityAmp: Invalid amplitude index.")
    pair = E.get_amp_pair(qureg.amps, int(row + col * dim)).cpu()
    return complex(float(pair[0]), float(pair[1]))


def calcProbOfOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    """Probability of measuring the given outcome of one qubit
    (QuEST.h:3047)."""
    V.validate_target(qureg, measureQubit, "calcProbOfOutcome")
    V.validate_outcome(outcome, "calcProbOfOutcome")
    if qureg.is_density_matrix:
        p = C.calc_prob_of_outcome_density(
            qureg.amps, num_qubits=qureg.num_qubits_represented,
            target=measureQubit, outcome=outcome, quad=_quad())
    else:
        p = C.calc_prob_of_outcome_statevec(
            qureg.amps, num_qubits=qureg.num_qubits_in_state_vec,
            target=measureQubit, outcome=outcome, quad=_quad())
    return float(p)


def calcProbOfAllOutcomes(qureg: Qureg, qubits: Sequence[int]) -> np.ndarray:
    """Probabilities of every outcome of a sub-register measurement
    (QuEST.h:3136); outcome index bit j <-> qubits[j]."""
    qubits = [int(q) for q in qubits]
    V.validate_multi_targets(qureg, qubits, "calcProbOfAllOutcomes")
    if qureg.is_density_matrix:
        p = C.calc_prob_of_all_outcomes_density(
            qureg.amps, num_qubits=qureg.num_qubits_represented,
            qubits=tuple(qubits))
    else:
        p = C.calc_prob_of_all_outcomes_statevec(
            qureg.amps, num_qubits=qureg.num_qubits_in_state_vec,
            qubits=tuple(qubits))
    return p.cpu().numpy()


# ---------------------------------------------------------------------------
# Measurement (QuEST.c:985-995, QuEST_common.c:168-183,374-380)
# ---------------------------------------------------------------------------


def _generate_measurement_outcome(zero_prob: float) -> int:
    """generateMeasurementOutcome (QuEST_common.c:168-183): degenerate
    probabilities short-circuit; otherwise draw from the host MT."""
    if zero_prob < real_eps():
        return 1
    if 1 - zero_prob < real_eps():
        return 0
    return 0 if GLOBAL_RNG.uniform() <= zero_prob else 1


def _collapse(qureg: Qureg, qubit: int, outcome: int, prob: float) -> None:
    if qureg.is_density_matrix:
        qureg.amps = K.collapse_density(
            qureg.amps, float(prob), num_qubits=qureg.num_qubits_represented,
            target=qubit, outcome=outcome)
    else:
        qureg.amps = K.collapse_statevec(
            qureg.amps, float(prob), num_qubits=_sv_n(qureg), target=qubit,
            outcome=outcome)


def collapseToOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    """Project one qubit onto a known outcome and renormalise
    (QuEST.h:3170); returns the outcome's probability."""
    V.validate_target(qureg, measureQubit, "collapseToOutcome")
    V.validate_outcome(outcome, "collapseToOutcome")
    prob = calcProbOfOutcome(qureg, measureQubit, outcome)
    if prob < real_eps():
        raise V.QuESTError(
            "collapseToOutcome: Can't collapse to state with zero "
            "probability.")
    _collapse(qureg, measureQubit, outcome, prob)
    qureg.qasm_log.comment(
        f"collapseToOutcome({outcome}) on qubit {measureQubit}")
    return prob


def measure(qureg: Qureg, measureQubit: int) -> int:
    """Measure one qubit, collapsing the state (QuEST.h:3194)."""
    outcome, _ = measureWithStats(qureg, measureQubit)
    return outcome


def measureWithStats(qureg: Qureg, measureQubit: int):
    """Measure one qubit, also returning the outcome's probability
    (QuEST.h:3219).  By default the probability, the threefry threshold
    of the next shot and the collapse run on the register's device
    (ops/measurement.py), with one device-to-host copy for the result;
    QT_HOST_MEASURE=1 (or QT_STRICT_VALIDATION=1) takes the reference's
    host Mersenne-Twister stream instead (calcProbOfOutcome ->
    generateMeasurementOutcome -> collapse)."""
    _refuse_bank(qureg, "measureWithStats")
    V.validate_target(qureg, measureQubit, "measureWithStats")
    if M.host_path_enabled():
        zero_prob = calcProbOfOutcome(qureg, measureQubit, 0)
        outcome = _generate_measurement_outcome(zero_prob)
        prob = zero_prob if outcome == 0 else 1 - zero_prob
        _collapse(qureg, measureQubit, outcome, prob)
        qureg.qasm_log.measure(measureQubit)
        return outcome, prob
    key, shot = M.KEYS.next_shots()
    amps, outcome, prob = M.measure_fused(
        qureg.amps, key, shot, num_qubits=qureg.num_qubits_represented,
        target=measureQubit, is_density=qureg.is_density_matrix,
        quad=_quad())
    qureg.amps = amps
    qureg.qasm_log.measure(measureQubit)
    outs, probs = M.to_host(outcome[None], prob[None])
    return outs[0], probs[0]


def measureSequence(qureg: Qureg, qubits: Sequence[int]):
    """Measure a sequence of qubits, each step collapsing before the next
    qubit's probability is taken, exactly as a loop of measureWithStats
    calls would (the same seeded outcomes and probabilities), but with
    one threshold upload and one device-to-host copy for the whole
    sequence (an extension: the reference's measure is one host round
    trip per qubit).  Returns (outcomes, probabilities) lists.  Under
    QT_HOST_MEASURE=1 it is a loop of host-route measureWithStats."""
    _refuse_bank(qureg, "measureSequence")
    qubits = [int(q) for q in qubits]
    for q in qubits:
        V.validate_target(qureg, q, "measureSequence")
    if not qubits:
        return [], []
    if M.host_path_enabled():
        outs, probs = [], []
        for q in qubits:
            o, p = measureWithStats(qureg, q)
            outs.append(o)
            probs.append(p)
        return outs, probs
    key, shot = M.KEYS.next_shots(len(qubits))
    amps, outs, probs = M.measure_sequence(
        qureg.amps, key, shot, num_qubits=qureg.num_qubits_represented,
        targets=tuple(qubits), is_density=qureg.is_density_matrix,
        quad=_quad())
    qureg.amps = amps
    for q in qubits:
        qureg.qasm_log.measure(q)
    return M.to_host(outs, probs)


def calcTotalProb(qureg: Qureg) -> float:
    """Total probability (trace / norm^2) of the register (QuEST.h:2099);
    in double-double under quad precision."""
    if qureg.is_density_matrix:
        if _quad():
            return float(C.calc_total_prob_density_quad(
                qureg.amps, num_qubits=qureg.num_qubits_represented))
        return float(C.calc_total_prob_density(
            qureg.amps, num_qubits=qureg.num_qubits_represented))
    if _quad():
        return float(C.calc_total_prob_statevec_quad(qureg.amps))
    return float(C.calc_total_prob_statevec(qureg.amps))


def calcInnerProduct(bra: Qureg, ket: Qureg) -> complex:
    """Complex inner product <bra|ket> of two state-vectors
    (QuEST.h:3246)."""
    V.validate_state_vector(bra, "calcInnerProduct")
    V.validate_state_vector(ket, "calcInnerProduct")
    V.validate_matching_qureg_dims(bra, ket, "calcInnerProduct")
    ip = C.calc_inner_product_quad if _quad() else C.calc_inner_product
    r = ip(bra.amps, ket.amps).cpu()
    return complex(float(r[0]), float(r[1]))


def calcDensityInnerProduct(rho1: Qureg, rho2: Qureg) -> float:
    """Hilbert-Schmidt inner product Tr(rho1^dag rho2) of two density
    matrices (QuEST.h:3299)."""
    V.validate_density_matrix(rho1, "calcDensityInnerProduct")
    V.validate_density_matrix(rho2, "calcDensityInnerProduct")
    V.validate_matching_qureg_dims(rho1, rho2, "calcDensityInnerProduct")
    return float(C.calc_density_inner_product(rho1.amps, rho2.amps,
                                              quad=_quad()))


def calcPurity(qureg: Qureg) -> float:
    """Purity Tr(rho^2) of a density matrix (QuEST.h:3692)."""
    V.validate_density_matrix(qureg, "calcPurity")
    return float(C.calc_purity(qureg.amps, quad=_quad()))


def calcFidelity(qureg: Qureg, pureState: Qureg) -> float:
    """Fidelity of a register against a pure reference state
    (QuEST.h:3724): <psi|rho|psi>, or |<psi|phi>|^2."""
    V.validate_second_qureg_state_vec(pureState, "calcFidelity")
    V.validate_matching_qureg_dims(qureg, pureState, "calcFidelity")
    if qureg.is_density_matrix:
        return float(C.calc_fidelity_density(
            qureg.amps, pureState.amps,
            num_qubits=qureg.num_qubits_represented, quad=_quad()))
    ip_fn = C.calc_inner_product_quad if _quad() else C.calc_inner_product
    ip = ip_fn(qureg.amps, pureState.amps).cpu()
    return float(ip[0] ** 2 + ip[1] ** 2)


def calcHilbertSchmidtDistance(a: Qureg, b: Qureg) -> float:
    """Hilbert-Schmidt distance between two density matrices
    (QuEST.h:4911)."""
    V.validate_density_matrix(a, "calcHilbertSchmidtDistance")
    V.validate_density_matrix(b, "calcHilbertSchmidtDistance")
    V.validate_matching_qureg_dims(a, b, "calcHilbertSchmidtDistance")
    return float(C.calc_hilbert_schmidt_distance(a.amps, b.amps,
                                                 quad=_quad()))


# ---------------------------------------------------------------------------
# Decoherence (QuEST.c:1259-1331; channels in ops/density.py)
# ---------------------------------------------------------------------------


def _capture_channel(qureg: Qureg, ops, targets) -> bool:
    """Under gateFusion, buffer a Kraus channel as its superoperator, a
    dense gate on (T, T+n) that the drain plans with the gates."""
    if qureg._fusion is None:
        return False
    sup = D.superoperator_from_kraus(ops)
    sv_targets = D.kraus_targets(tuple(targets), qureg.num_qubits_represented)
    dt = np.float64 if qureg.dtype == torch.float64 else np.float32
    return fusion.capture_raw(qureg, CX.soa(sup).astype(dt), sv_targets)


def _mix_kraus(qureg: Qureg, ops, targets) -> None:
    """A Kraus channel: captured under gateFusion, else the superoperator
    applied now (QuEST_common.c:630-652)."""
    if _capture_channel(qureg, ops, targets):
        return
    qureg.amps = D.apply_kraus_map(
        qureg.amps, ops, num_qubits=qureg.num_qubits_represented,
        targets=tuple(targets))


def mixDephasing(qureg: Qureg, targetQubit: int, prob: float) -> None:
    """One-qubit dephasing channel (QuEST.h:3421)."""
    V.validate_density_matrix(qureg, "mixDephasing")
    V.validate_target(qureg, targetQubit, "mixDephasing")
    V.validate_one_qubit_dephase_prob(prob, "mixDephasing")
    if _capture_channel(
            qureg,
            [math.sqrt(1 - prob) * G.PAULI_I, math.sqrt(prob) * G.PAULI_Z],
            (targetQubit,)):
        return
    qureg.amps = D.mix_dephasing(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        target=targetQubit)


def mixTwoQubitDephasing(qureg: Qureg, qubit1: int, qubit2: int,
                         prob: float) -> None:
    """Two-qubit dephasing channel (QuEST.h:3453)."""
    V.validate_density_matrix(qureg, "mixTwoQubitDephasing")
    V.validate_unique_targets(qureg, qubit1, qubit2, "mixTwoQubitDephasing")
    V.validate_two_qubit_dephase_prob(prob, "mixTwoQubitDephasing")
    i2, z = G.PAULI_I, G.PAULI_Z
    # Kraus order (q2 (x) q1): matrix bit 0 = qubit1
    ops = [math.sqrt(1 - prob) * np.kron(i2, i2),
           math.sqrt(prob / 3) * np.kron(i2, z),
           math.sqrt(prob / 3) * np.kron(z, i2),
           math.sqrt(prob / 3) * np.kron(z, z)]
    if _capture_channel(qureg, ops, (qubit1, qubit2)):
        return
    qureg.amps = D.mix_two_qubit_dephasing(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        qubit1=qubit1, qubit2=qubit2)


def mixDepolarising(qureg: Qureg, targetQubit: int, prob: float) -> None:
    """One-qubit depolarising channel (QuEST.h:3496): captured as a
    ChannelItem under gateFusion, else the elementwise pair form
    (QuEST_cpu.c:125-246)."""
    V.validate_density_matrix(qureg, "mixDepolarising")
    V.validate_target(qureg, targetQubit, "mixDepolarising")
    V.validate_one_qubit_depol_prob(prob, "mixDepolarising")
    if fusion.capture_pair_channel(qureg, "depol", targetQubit, prob):
        return
    qureg.amps = D.mix_depolarising(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        target=targetQubit)


def mixDamping(qureg: Qureg, targetQubit: int, prob: float) -> None:
    """One-qubit amplitude damping channel (QuEST.h:3534); routed as
    mixDepolarising (QuEST_cpu.c:300-385)."""
    V.validate_density_matrix(qureg, "mixDamping")
    V.validate_target(qureg, targetQubit, "mixDamping")
    V.validate_one_qubit_damping_prob(prob, "mixDamping")
    if fusion.capture_pair_channel(qureg, "damping", targetQubit, prob):
        return
    qureg.amps = D.mix_damping(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        target=targetQubit)


def mixTwoQubitDepolarising(qureg: Qureg, qubit1: int, qubit2: int,
                            prob: float) -> None:
    """Two-qubit depolarising channel (QuEST.h:3601): captured as its
    superoperator under gateFusion, else the elementwise orbit form
    (QuEST_cpu.c:387-733)."""
    V.validate_density_matrix(qureg, "mixTwoQubitDepolarising")
    V.validate_unique_targets(qureg, qubit1, qubit2,
                              "mixTwoQubitDepolarising")
    V.validate_two_qubit_depol_prob(prob, "mixTwoQubitDepolarising")
    if _capture_channel(qureg, D.two_qubit_depolarising_kraus(prob),
                        (qubit1, qubit2)):
        return
    qureg.amps = D.mix_two_qubit_depolarising(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        qubit1=qubit1, qubit2=qubit2)


def mixPauli(qureg: Qureg, targetQubit: int, probX: float, probY: float,
             probZ: float) -> None:
    """One-qubit Pauli channel with probabilities (pX, pY, pZ)
    (QuEST.h:3642)."""
    V.validate_density_matrix(qureg, "mixPauli")
    V.validate_target(qureg, targetQubit, "mixPauli")
    V.validate_one_qubit_pauli_probs(probX, probY, probZ, "mixPauli")
    _mix_kraus(qureg, D.pauli_kraus(probX, probY, probZ), (targetQubit,))


def mixDensityMatrix(combineQureg: Qureg, prob: float,
                     otherQureg: Qureg) -> None:
    """rho = (1-p) rho + p other (QuEST.h:3664)."""
    V.validate_density_matrix(combineQureg, "mixDensityMatrix")
    V.validate_density_matrix(otherQureg, "mixDensityMatrix")
    V.validate_matching_qureg_dims(combineQureg, otherQureg,
                                   "mixDensityMatrix")
    V.validate_prob(prob, "mixDensityMatrix")
    combineQureg.amps = D.mix_density_matrix(combineQureg.amps,
                                             otherQureg.amps, prob)


def _kraus_list(ops, numOps):
    ops = list(ops)[: int(numOps)] if numOps is not None else list(ops)
    return ops


def mixKrausMap(qureg: Qureg, target: int, ops,
                numOps: Optional[int] = None) -> None:
    """A one-qubit CPTP Kraus map (QuEST.h:4789)."""
    ops = _kraus_list(ops, numOps)
    V.validate_density_matrix(qureg, "mixKrausMap")
    V.validate_target(qureg, target, "mixKrausMap")
    V.validate_kraus_ops(ops, 1, "mixKrausMap")
    _mix_kraus(qureg, [np.asarray(o, complex) for o in ops], (target,))


def mixTwoQubitKrausMap(qureg: Qureg, target1: int, target2: int, ops,
                        numOps: Optional[int] = None) -> None:
    """A two-qubit CPTP Kraus map (QuEST.h:4828)."""
    ops = _kraus_list(ops, numOps)
    V.validate_density_matrix(qureg, "mixTwoQubitKrausMap")
    V.validate_unique_targets(qureg, target1, target2, "mixTwoQubitKrausMap")
    V.validate_kraus_ops(ops, 2, "mixTwoQubitKrausMap")
    _mix_kraus(qureg, [np.asarray(o, complex) for o in ops],
               (target1, target2))


def mixMultiQubitKrausMap(qureg: Qureg, targets: Sequence[int], ops,
                          numOps: Optional[int] = None) -> None:
    """An N-qubit CPTP Kraus map (QuEST.h:4878)."""
    ops = _kraus_list(ops, numOps)
    targets = [int(t) for t in targets]
    V.validate_density_matrix(qureg, "mixMultiQubitKrausMap")
    V.validate_multi_targets(qureg, targets, "mixMultiQubitKrausMap")
    V.validate_multi_qubit_matrix_fits_in_node(qureg, 2 * len(targets),
                                               "mixMultiQubitKrausMap")
    V.validate_kraus_ops(ops, len(targets), "mixMultiQubitKrausMap")
    _mix_kraus(qureg, [np.asarray(o, complex) for o in ops], tuple(targets))


# ---------------------------------------------------------------------------
# Weighted sums and raw matrices: the apply* family takes NO unitarity
# check and NO density-matrix twin (QuEST.c:1074-1105)
# ---------------------------------------------------------------------------


def setWeightedQureg(fac1, qureg1: Qureg, fac2, qureg2: Qureg, facOut,
                     out: Qureg) -> None:
    """out = fac1 qureg1 + fac2 qureg2 + facOut out (QuEST.h:4936)."""
    V.validate_matching_qureg_types(qureg1, qureg2, "setWeightedQureg")
    V.validate_matching_qureg_types(qureg1, out, "setWeightedQureg")
    V.validate_matching_qureg_dims(qureg1, qureg2, "setWeightedQureg")
    V.validate_matching_qureg_dims(qureg1, out, "setWeightedQureg")
    f = [complex(facOut), complex(fac1), complex(fac2)]
    facs = np.array([[c.real for c in f], [c.imag for c in f]])
    out.amps = K.set_weighted_qureg(out.amps, qureg1.amps, qureg2.amps, facs)


def _apply_matrix_raw(qureg: Qureg, m, targets, controls=()) -> None:
    qureg.amps = K.apply_matrix(
        qureg.amps, CX.soa(m), num_qubits=_sv_n(qureg),
        targets=tuple(int(t) for t in targets),
        controls=tuple(int(c) for c in controls))
    qureg.qasm_log.comment(
        "here a numeric matrix was applied (not recordable in QASM)")


def applyMatrix2(qureg: Qureg, targetQubit: int, u) -> None:
    """Left-multiply an arbitrary 2x2 matrix (QuEST.h:5140)."""
    V.validate_target(qureg, targetQubit, "applyMatrix2")
    V.validate_matrix_size(u, 1, "applyMatrix2")
    _apply_matrix_raw(qureg, u, (targetQubit,))


def applyMatrix4(qureg: Qureg, targetQubit1: int, targetQubit2: int,
                 u) -> None:
    """Left-multiply an arbitrary 4x4 matrix (QuEST.h:5192)."""
    V.validate_unique_targets(qureg, targetQubit1, targetQubit2,
                              "applyMatrix4")
    V.validate_matrix_size(u, 2, "applyMatrix4")
    _apply_matrix_raw(qureg, u, (targetQubit1, targetQubit2))


def applyMatrixN(qureg: Qureg, targs: Sequence[int], u) -> None:
    """Left-multiply an arbitrary 2^N x 2^N matrix (QuEST.h:5260)."""
    targets = [int(t) for t in targs]
    V.validate_multi_targets(qureg, targets, "applyMatrixN")
    V.validate_multi_qubit_matrix_fits_in_node(qureg, len(targets),
                                               "applyMatrixN")
    V.validate_matrix_size(u, len(targets), "applyMatrixN")
    _apply_matrix_raw(qureg, u, tuple(targets))


def applyMultiControlledMatrixN(qureg: Qureg, ctrls: Sequence[int],
                                targs: Sequence[int], u) -> None:
    """Left-multiply a controlled arbitrary matrix (QuEST.h:5313)."""
    controls = [int(c) for c in ctrls]
    targets = [int(t) for t in targs]
    V.validate_multi_controls_targets(qureg, controls, targets,
                                      "applyMultiControlledMatrixN")
    V.validate_matrix_size(u, len(targets), "applyMultiControlledMatrixN")
    _apply_matrix_raw(qureg, u, tuple(targets), tuple(controls))


# ---------------------------------------------------------------------------
# Pauli sums and PauliHamil (QuEST.h:4189-4285, 4995-5039)
# ---------------------------------------------------------------------------


def _full_codes(qureg, targets, codes) -> tuple:
    full = [PAULI_I] * qureg.num_qubits_represented
    for t, c in zip(targets, codes):
        full[t] = int(c)
    return tuple(full)


def calcExpecPauliProd(qureg: Qureg, targetQubits, pauliCodes,
                       workspace: Optional[Qureg] = None) -> float:
    """Expected value of a product of Pauli operators (QuEST.h:4189); the
    workspace register is not needed."""
    targets = [int(t) for t in targetQubits]
    codes = [int(c) for c in pauliCodes]
    V.validate_multi_targets(qureg, targets, "calcExpecPauliProd")
    V.validate_pauli_codes(codes, "calcExpecPauliProd")
    calc = (P.calc_expec_pauli_sum_density if qureg.is_density_matrix
            else P.calc_expec_pauli_sum_statevec)
    return float(calc(qureg.amps, np.ones(1),
                      num_qubits=qureg.num_qubits_represented,
                      codes_flat=_full_codes(qureg, targets, codes),
                      num_terms=1, quad=_quad()))


def calcExpecPauliSum(qureg: Qureg, allPauliCodes, termCoeffs,
                      workspace: Optional[Qureg] = None) -> float:
    """Expected value of a weighted sum of Pauli products (QuEST.h:4244).
    A state vector runs one K4 launch per term (expec_pauli_sum_scan); a
    density matrix takes the plain trace form."""
    n = qureg.num_qubits_represented
    codes = tuple(int(c) for c in np.asarray(allPauliCodes).ravel())
    coeffs = np.asarray(termCoeffs, dtype=np.float64)
    num_terms = coeffs.size
    V.validate_num_pauli_sum_terms(num_terms, "calcExpecPauliSum")
    if len(codes) != num_terms * n:
        raise V.QuESTError("calcExpecPauliSum: Number of Pauli codes doesn't "
                           "match numSumTerms*numQubits.")
    V.validate_pauli_codes(codes, "calcExpecPauliSum")
    if qureg.is_density_matrix:
        val = P.calc_expec_pauli_sum_density(
            qureg.amps, coeffs, num_qubits=n, codes_flat=codes,
            num_terms=num_terms, quad=_quad())
    else:
        val = P.expec_pauli_sum_scan(
            qureg.amps, np.asarray(codes, np.int32).reshape(num_terms, n),
            coeffs, num_qubits=n, quad=_quad())
    return float(val)


def calcExpecPauliHamil(qureg: Qureg, hamil: PauliHamil,
                        workspace: Optional[Qureg] = None) -> float:
    """Expected value of a PauliHamil (QuEST.h:4285)."""
    V.validate_pauli_hamil(hamil, "calcExpecPauliHamil")
    V.validate_hamil_matches_qureg(hamil, qureg, "calcExpecPauliHamil")
    return calcExpecPauliSum(qureg, hamil.pauli_codes, hamil.term_coeffs,
                             workspace)


def calcExpecDiagonalOp(qureg: Qureg, op: DiagonalOp) -> complex:
    """Expected value of a diagonal operator in the given state
    (QuEST.h:1255)."""
    V.validate_diag_op_matches_qureg(op, qureg, "calcExpecDiagonalOp")
    if qureg.is_density_matrix:
        r = C.calc_expec_diagonal_density(
            qureg.amps, op.real, op.imag,
            num_qubits=qureg.num_qubits_represented, quad=_quad())
    else:
        r = C.calc_expec_diagonal_statevec(qureg.amps, op.real, op.imag,
                                           quad=_quad())
    r = r.cpu()
    return complex(float(r[0]), float(r[1]))


def applyPauliSum(inQureg: Qureg, allPauliCodes, termCoeffs,
                  outQureg: Qureg) -> None:
    """Left-multiply a weighted sum of Pauli products, writing outQureg
    (QuEST.h:4995)."""
    n = inQureg.num_qubits_represented
    codes = tuple(int(c) for c in np.asarray(allPauliCodes).ravel())
    coeffs = np.asarray(termCoeffs, dtype=np.float64)
    num_terms = coeffs.size
    V.validate_num_pauli_sum_terms(num_terms, "applyPauliSum")
    if len(codes) != num_terms * n:
        raise V.QuESTError("applyPauliSum: Number of Pauli codes doesn't "
                           "match numSumTerms*numQubits.")
    V.validate_pauli_codes(codes, "applyPauliSum")
    V.validate_matching_qureg_types(inQureg, outQureg, "applyPauliSum")
    V.validate_matching_qureg_dims(inQureg, outQureg, "applyPauliSum")
    outQureg.amps = P.apply_pauli_sum(
        inQureg.amps, coeffs, num_qubits=n,
        num_state_qubits=inQureg.num_qubits_in_state_vec, codes_flat=codes,
        num_terms=num_terms)


def applyPauliHamil(inQureg: Qureg, hamil: PauliHamil,
                    outQureg: Qureg) -> None:
    """Left-multiply a PauliHamil onto inQureg, writing outQureg
    (QuEST.h:5039)."""
    V.validate_pauli_hamil(hamil, "applyPauliHamil")
    V.validate_hamil_matches_qureg(hamil, inQureg, "applyPauliHamil")
    applyPauliSum(inQureg, hamil.pauli_codes, hamil.term_coeffs, outQureg)


def applyTrotterCircuit(qureg: Qureg, hamil: PauliHamil, time: float,
                        order: int, reps: int) -> None:
    """Symmetrized Suzuki-Trotter e^{-iHt} (agnostic_applyTrotterCircuit,
    QuEST_common.c:752-834): one K3 launch per term rotation (two on a
    density matrix) through trotter_scan, which overwrites the register's
    tensor in place on the card.  While QASM is recording, the per-term
    multiRotatePauli stream runs instead, so each rotation is logged."""
    V.validate_pauli_hamil(hamil, "applyTrotterCircuit")
    V.validate_hamil_matches_qureg(hamil, qureg, "applyTrotterCircuit")
    V.validate_trotter_params(order, reps, "applyTrotterCircuit")
    if time == 0:
        return
    seq = _trotter_schedule(hamil.num_sum_terms, time, order, reps)
    if qureg.qasm_log.is_logging:
        targets = list(range(hamil.num_qubits))
        for t, fac in seq:
            multiRotatePauli(qureg, targets,
                             [int(c) for c in hamil.pauli_codes[t]],
                             2 * fac * float(hamil.term_coeffs[t]))
        return
    t_idx = np.asarray([t for t, _ in seq])
    facs = np.asarray([f for _, f in seq])
    qureg.amps = P.trotter_scan(
        qureg.amps, np.asarray(hamil.pauli_codes)[t_idx].astype(np.int32),
        2.0 * facs * np.asarray(hamil.term_coeffs, np.float64)[t_idx],
        num_qubits=qureg.num_qubits_in_state_vec,
        rep_qubits=qureg.num_qubits_represented)


def _trotter_schedule(num_terms: int, time: float, order: int, reps: int):
    """(term index, time factor) sequence of the symmetrized Suzuki
    recursion, flattened so the term loop can consume it as data."""
    seq = []

    def exp_hamil(fac, reverse):
        rng = range(num_terms)
        for t in (reversed(rng) if reverse else rng):
            seq.append((t, fac))

    def symm(t, o):
        if o == 1:
            exp_hamil(t, False)
        elif o == 2:
            exp_hamil(t / 2, False)
            exp_hamil(t / 2, True)
        else:
            p = 1.0 / (4 - 4 ** (1.0 / (o - 1)))
            lower = o - 2
            symm(p * t, lower)
            symm(p * t, lower)
            symm((1 - 4 * p) * t, lower)
            symm(p * t, lower)
            symm(p * t, lower)

    for _ in range(reps):
        symm(time / reps, order)
    return seq


# ---------------------------------------------------------------------------
# Diagonal operators and phase functions (QuEST.h:1255, 5571-6326)
# ---------------------------------------------------------------------------


def applyDiagonalOp(qureg: Qureg, op: DiagonalOp) -> None:
    """Left-multiplies D onto the state: on rho this is D rho, not
    D rho D^dag (the apply* family; densmatr path QuEST_cpu.c:4042-4082)."""
    V.validate_diag_op_matches_qureg(op, qureg, "applyDiagonalOp")
    if qureg.is_density_matrix:
        qureg.amps = D.apply_diagonal_op_density(
            qureg.amps, op.real, op.imag,
            num_qubits=qureg.num_qubits_represented)
    else:
        qureg.amps = K.apply_full_diagonal(qureg.amps, op.real, op.imag)
    qureg.qasm_log.comment("here a diagonal operator was applied")


def _norm_overrides(overrideInds, overridePhases, num_regs):
    if overrideInds is None or len(np.asarray(overridePhases).ravel()) == 0:
        return np.zeros((0, num_regs), np.int64), np.zeros((0,), np.float64)
    inds = np.asarray(overrideInds, np.int64).reshape(-1, num_regs)
    phases = np.asarray(overridePhases, np.float64).ravel()
    return inds, phases


def _pad_params(params, num_regs):
    """Named functions read their divergence and shift parameters at
    fixed slots (QuEST_cpu.c:4484-4543): pad to the largest layout (the
    shifted norm's)."""
    p = (np.asarray(params, np.float64).ravel() if params is not None
         else np.zeros(0))
    need = 2 + num_regs
    if p.size < need:
        p = np.concatenate([p, np.zeros(need - p.size)])
    return p


def _split_regs(qubits, numQubitsPerReg):
    regs = []
    flat = [int(q) for q in np.asarray(qubits).ravel()]
    pos = 0
    for nq in numQubitsPerReg:
        regs.append(tuple(flat[pos:pos + int(nq)]))
        pos += int(nq)
    return tuple(regs)


def applyPhaseFunc(qureg: Qureg, qubits, encoding, coeffs,
                   exponents) -> None:
    """exp(i sum_i c_i x^e_i) with x the integer of one sub-register
    (QuEST.h:5571)."""
    applyPhaseFuncOverrides(qureg, qubits, encoding, coeffs, exponents,
                            None, None)


def applyPhaseFuncOverrides(qureg: Qureg, qubits, encoding, coeffs,
                            exponents, overrideInds, overridePhases) -> None:
    """Single-variable phase function with explicit per-index overrides
    (QuEST.h:5682)."""
    qubits = [int(q) for q in qubits]
    V.validate_qubit_subregs(qureg, [qubits], "applyPhaseFunc")
    V.validate_bit_encoding(int(encoding), "applyPhaseFunc",
                            num_qubits=len(qubits))
    inds, phases = _norm_overrides(overrideInds, overridePhases, 1)
    V.validate_phase_func_terms(len(qubits), int(encoding), coeffs,
                                exponents, [i[0] for i in inds],
                                "applyPhaseFunc")
    V.validate_phase_func_overrides([len(qubits)], int(encoding), inds,
                                    "applyPhaseFunc")
    qureg.amps = PF.apply_phase_func(
        qureg.amps, np.asarray(coeffs, np.float64),
        np.asarray(exponents, np.float64), inds, phases,
        num_qubits=_sv_n(qureg), qubits=tuple(qubits),
        encoding=int(encoding))
    qureg.qasm_log.phase_func(
        qubits, int(encoding), list(np.asarray(coeffs, np.float64).ravel()),
        list(np.asarray(exponents, np.float64).ravel()), inds, phases)


def applyMultiVarPhaseFunc(qureg: Qureg, qubits, numQubitsPerReg, encoding,
                           coeffs, exponents, numTermsPerReg) -> None:
    """exp(i sum_r sum_t c x_r^e) over several sub-registers
    (QuEST.h:5843)."""
    applyMultiVarPhaseFuncOverrides(qureg, qubits, numQubitsPerReg,
                                    encoding, coeffs, exponents,
                                    numTermsPerReg, None, None)


def applyMultiVarPhaseFuncOverrides(qureg: Qureg, qubits, numQubitsPerReg,
                                    encoding, coeffs, exponents,
                                    numTermsPerReg, overrideInds,
                                    overridePhases) -> None:
    """Multi-variable phase function with explicit per-index overrides
    (QuEST.h:5925)."""
    regs = _split_regs(qubits, numQubitsPerReg)
    V.validate_qubit_subregs(qureg, [list(r) for r in regs],
                             "applyMultiVarPhaseFunc")
    V.validate_multi_reg_bit_encoding([len(r) for r in regs], int(encoding),
                                      "applyMultiVarPhaseFunc")
    exps = np.asarray(exponents, np.float64)
    pos = 0
    exps_per_reg = []
    for t in numTermsPerReg:
        exps_per_reg.append(exps[pos:pos + int(t)])
        pos += int(t)
    V.validate_multi_var_phase_func_terms(
        [len(r) for r in regs], int(encoding), exps_per_reg,
        "applyMultiVarPhaseFunc")
    inds, phases = _norm_overrides(overrideInds, overridePhases, len(regs))
    V.validate_phase_func_overrides([len(r) for r in regs], int(encoding),
                                    inds, "applyMultiVarPhaseFunc")
    qureg.amps = PF.apply_multi_var_phase_func(
        qureg.amps, np.asarray(coeffs, np.float64), exps, inds, phases,
        num_qubits=_sv_n(qureg), reg_qubits=regs, encoding=int(encoding),
        terms_per_reg=tuple(int(t) for t in numTermsPerReg))
    qureg.qasm_log.multi_var_phase_func(
        regs, int(encoding), list(np.asarray(coeffs, np.float64).ravel()),
        list(exps.ravel()), [int(t) for t in numTermsPerReg], inds, phases)


def applyNamedPhaseFunc(qureg: Qureg, qubits, numQubitsPerReg, encoding,
                        functionNameCode) -> None:
    """One of the 14 named phase functions over sub-registers
    (QuEST.h:6065)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits, numQubitsPerReg,
                                      encoding, functionNameCode, None, None,
                                      None)


def applyNamedPhaseFuncOverrides(qureg: Qureg, qubits, numQubitsPerReg,
                                 encoding, functionNameCode, overrideInds,
                                 overridePhases) -> None:
    """A named phase function with per-index overrides (QuEST.h:6138)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits, numQubitsPerReg,
                                      encoding, functionNameCode, None,
                                      overrideInds, overridePhases)


def applyParamNamedPhaseFunc(qureg: Qureg, qubits, numQubitsPerReg,
                             encoding, functionNameCode, params) -> None:
    """A named phase function with its scalar parameters (QuEST.h:6251)."""
    applyParamNamedPhaseFuncOverrides(qureg, qubits, numQubitsPerReg,
                                      encoding, functionNameCode, params,
                                      None, None)


def applyParamNamedPhaseFuncOverrides(qureg: Qureg, qubits, numQubitsPerReg,
                                      encoding, functionNameCode, params,
                                      overrideInds, overridePhases) -> None:
    """A named phase function with parameters and per-index overrides
    (QuEST.h:6326)."""
    regs = _split_regs(qubits, numQubitsPerReg)
    V.validate_qubit_subregs(qureg, [list(r) for r in regs],
                             "applyNamedPhaseFunc")
    V.validate_multi_reg_bit_encoding([len(r) for r in regs], int(encoding),
                                      "applyNamedPhaseFunc")
    num_params = 0 if params is None else int(np.asarray(params).size)
    V.validate_phase_func_name(int(functionNameCode), len(regs), num_params,
                               "applyNamedPhaseFunc")
    inds, phases = _norm_overrides(overrideInds, overridePhases, len(regs))
    V.validate_phase_func_overrides([len(r) for r in regs], int(encoding),
                                    inds, "applyNamedPhaseFunc")
    qureg.amps = PF.apply_named_phase_func(
        qureg.amps, _pad_params(params, len(regs)), inds, phases,
        num_qubits=_sv_n(qureg), reg_qubits=regs, encoding=int(encoding),
        func_name=int(functionNameCode))
    qureg.qasm_log.named_phase_func(
        regs, int(encoding), int(functionNameCode),
        [] if params is None else list(np.asarray(params, np.float64).ravel()),
        inds, phases)


# ---------------------------------------------------------------------------
# QFT (agnostic_applyQFT, QuEST_common.c:836-898)
# ---------------------------------------------------------------------------


def applyQFT(qureg: Qureg, qubits: Sequence[int],
             numQubits: Optional[int] = None) -> None:
    """Apply the quantum Fourier transform to the given qubits
    (QuEST.h:6536)."""
    qubits = [int(q) for q in qubits]
    V.validate_multi_targets(qureg, qubits, "applyQFT")
    _apply_qft(qureg, qubits)


def applyFullQFT(qureg: Qureg) -> None:
    """Apply the quantum Fourier transform to every qubit (QuEST.h:6420)."""
    _apply_qft(qureg, list(range(qureg.num_qubits_represented)))


def _apply_qft(qureg: Qureg, qubits) -> None:
    """The fused route where it applies, else the layered one: per layer
    a Hadamard and the controlled-phase ladder as one SCALED_PRODUCT phase
    function (and its conjugated bra twin on a density matrix), then the
    swaps."""
    if _qft_fused(qureg, qubits):
        return
    n = len(qubits)
    for q in range(n - 1, -1, -1):
        hadamard(qureg, qubits[q])
        if q == 0:
            break
        # the ladder: theta = (pi / 2^q) * x_low * x_q; the scale sits in
        # slot 0, the divergence value and the two shifts' slots stay 0
        # (QuEST_cpu.c:4484-4543)
        regs = (tuple(qubits[:q]), (qubits[q],))
        params = np.array([math.pi / (1 << q), 0.0, 0.0, 0.0])
        inds = np.zeros((0, 2), np.int64)
        phases = np.zeros((0,), np.float64)
        qureg.amps = PF.apply_named_phase_func(
            qureg.amps, params, inds, phases, num_qubits=_sv_n(qureg),
            reg_qubits=regs, encoding=PF.UNSIGNED,
            func_name=PF.SCALED_PRODUCT, conj=False)
        if qureg.is_density_matrix:
            sh = _shift(qureg)
            sregs = tuple(tuple(x + sh for x in reg) for reg in regs)
            qureg.amps = PF.apply_named_phase_func(
                qureg.amps, params, inds, phases, num_qubits=_sv_n(qureg),
                reg_qubits=sregs, encoding=PF.UNSIGNED,
                func_name=PF.SCALED_PRODUCT, conj=True)
        qureg.qasm_log.comment(
            "here a controlled-phase ladder (QFT layer) was applied")
    for i in range(n // 2):
        swapGate(qureg, qubits[i], qubits[n - i - 1])


def _qft_fused(qureg: Qureg, qubits) -> bool:
    """The fused QFT (circuit.fused_qft): ladder passes, one scheduled
    low-qubit window pass and one bit reversal for the whole swap network
    (both halves at once on a density matrix).  Applies when the qubits
    are a contiguous ascending run starting at 0 or >= 7 and the state
    vector is window-sized (>= 14 qubits); otherwise returns False and the
    layered path runs."""
    nsv = _sv_n(qureg)
    if nsv < CIRC.WINDOW:
        return False
    nt = len(qubits)
    start = qubits[0]
    if list(qubits) != list(range(start, start + nt)):
        return False
    if not (start == 0 or start >= CIRC.LANE):
        return False
    shifts = [0, _shift(qureg)] if qureg.is_density_matrix else [0]
    qureg.amps = CIRC.fused_qft(qureg.amps, nsv, start, nt, shifts=shifts)
    _qft_qasm_trail(qureg, qubits, nt)
    return True


def _qft_qasm_trail(qureg: Qureg, qubits, nt: int) -> None:
    """The QASM record of the layered path's gates."""
    for q in range(nt - 1, -1, -1):
        qureg.qasm_log.gate("h", (), qubits[q])
        if q:
            qureg.qasm_log.comment(
                "here a controlled-phase ladder (QFT layer) was applied")
    for i in range(nt // 2):
        qureg.qasm_log.gate("swap", (qubits[i],), qubits[nt - 1 - i])


# ---------------------------------------------------------------------------
# Circuit optimizer mode (optimizer.py)
# ---------------------------------------------------------------------------


def setCircuitOptimizer(mode: Optional[str]) -> None:
    """Select the circuit optimizer's mode for later fusion drains:
    ``"off"``, ``"on"`` (cancellation/merging and diagonal and
    permutation coalescing) or ``"aggressive"`` (also drops merged pairs
    that are the identity up to rounding).  ``None`` returns control to
    the ``QT_OPTIMIZER`` environment variable."""
    _optimizer.set_circuit_optimizer(mode)


def getCircuitOptimizer() -> str:
    """The active circuit-optimizer mode."""
    return _optimizer.get_circuit_optimizer()


# ---------------------------------------------------------------------------
# QASM recording (QuEST.h:3351-3390)
# ---------------------------------------------------------------------------


def startRecordingQASM(qureg: Qureg) -> None:
    """Begin recording API gates as OPENQASM 2.0 (QuEST.h:3351)."""
    qureg.qasm_log.start()


def stopRecordingQASM(qureg: Qureg) -> None:
    """Stop recording QASM (QuEST.h:3362)."""
    qureg.qasm_log.stop()


def clearRecordedQASM(qureg: Qureg) -> None:
    """Clear the register's recorded QASM (QuEST.h:3370)."""
    qureg.qasm_log.clear()


def printRecordedQASM(qureg: Qureg) -> None:
    """Print the recorded QASM to stdout (QuEST.h:3379)."""
    print(str(qureg.qasm_log), end="")


def writeRecordedQASMToFile(qureg: Qureg, filename: str) -> None:
    """Write the recorded QASM to a file (QuEST.h:3390)."""
    try:
        with open(filename, "w") as f:
            f.write(str(qureg.qasm_log))
    except OSError:
        raise V.QuESTError(
            f"writeRecordedQASMToFile: Could not open file {filename}")
