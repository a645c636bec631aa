"""Public API, part 2: amplitude reads, calculations, Pauli sums and
Trotter circuits, QASM recording.

Continues quest_tpu_torch.api (same conventions).  Reference parity:
QuEST.c calc* / get* / apply* functions.  Every read drains pending fused
gates through ``Qureg.amps`` first.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import validation as V
from .api import PAULI_I, multiRotatePauli
from .ops import calculations as C
from .ops import paulis as P
from .qureg import PauliHamil, Qureg


def getAmp(qureg: Qureg, index: int) -> complex:
    """Fetch one complex amplitude (QuEST.h:1987)."""
    V.validate_state_vector(qureg, "getAmp")
    V.validate_num_amps(qureg, index, 1, "getAmp")
    pair = qureg.amps[:, int(index)].cpu()
    return complex(float(pair[0]), float(pair[1]))


def getRealAmp(qureg: Qureg, index: int) -> float:
    """Fetch the real part of one amplitude (QuEST.h:2008)."""
    return getAmp(qureg, index).real


def getImagAmp(qureg: Qureg, index: int) -> float:
    """Fetch the imaginary part of one amplitude (QuEST.h:2029)."""
    return getAmp(qureg, index).imag


def calcProbOfOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    """Probability of measuring the given outcome of one qubit
    (QuEST.h:3047)."""
    V.validate_target(qureg, measureQubit, "calcProbOfOutcome")
    V.validate_outcome(outcome, "calcProbOfOutcome")
    if qureg.is_density_matrix:
        p = C.calc_prob_of_outcome_density(
            qureg.amps, num_qubits=qureg.num_qubits_represented,
            target=measureQubit, outcome=outcome)
    else:
        p = C.calc_prob_of_outcome_statevec(
            qureg.amps, num_qubits=qureg.num_qubits_in_state_vec,
            target=measureQubit, outcome=outcome)
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


def calcTotalProb(qureg: Qureg) -> float:
    """Total probability (trace / norm^2) of the register (QuEST.h:2099)."""
    if qureg.is_density_matrix:
        return float(C.calc_total_prob_density(
            qureg.amps, num_qubits=qureg.num_qubits_represented))
    return float(C.calc_total_prob_statevec(qureg.amps))


def calcInnerProduct(bra: Qureg, ket: Qureg) -> complex:
    """Complex inner product <bra|ket> of two state-vectors
    (QuEST.h:3246)."""
    V.validate_state_vector(bra, "calcInnerProduct")
    V.validate_state_vector(ket, "calcInnerProduct")
    V.validate_matching_qureg_dims(bra, ket, "calcInnerProduct")
    r = C.calc_inner_product(bra.amps, ket.amps).cpu()
    return complex(float(r[0]), float(r[1]))


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
                      num_terms=1))


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
            num_terms=num_terms)
    else:
        val = P.expec_pauli_sum_scan(
            qureg.amps, np.asarray(codes, np.int32).reshape(num_terms, n),
            coeffs, num_qubits=n)
    return float(val)


def calcExpecPauliHamil(qureg: Qureg, hamil: PauliHamil,
                        workspace: Optional[Qureg] = None) -> float:
    """Expected value of a PauliHamil (QuEST.h:4285)."""
    V.validate_pauli_hamil(hamil, "calcExpecPauliHamil")
    V.validate_hamil_matches_qureg(hamil, qureg, "calcExpecPauliHamil")
    return calcExpecPauliSum(qureg, hamil.pauli_codes, hamil.term_coeffs,
                             workspace)


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
# QASM recording (QuEST.h:3351-3362)
# ---------------------------------------------------------------------------


def startRecordingQASM(qureg: Qureg) -> None:
    """Begin recording API gates as OPENQASM 2.0 (QuEST.h:3351)."""
    qureg.qasm_log.start()


def stopRecordingQASM(qureg: Qureg) -> None:
    """Stop recording QASM (QuEST.h:3362)."""
    qureg.qasm_log.stop()
