"""Input validation for the ported API surface.

A copy of the checks the ported API functions call, with the reference's
message text kept VERBATIM (``QuEST_validation.c`` errorMessages table,
:119-197), so error tests written against the JAX package port one for
one.  Errors are raised as ``QuESTError``.  All checks run on the host,
on NumPy values, before any tensor is touched.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .precision import validation_eps


class QuESTError(ValueError):
    """Raised on invalid user input (reference invalidQuESTInputError,
    QuEST.h:5354)."""


# The reference's error messages for the codes the ported surface raises.
ERROR_MESSAGES = {
    "E_INVALID_NUM_CREATE_QUBITS": "Invalid number of qubits. Must create >0.",
    "E_INVALID_QUBIT_INDEX": "Invalid qubit index. Must be >=0 and <numQubits.",
    "E_INVALID_TARGET_QUBIT": "Invalid target qubit. Must be >=0 and <numQubits.",
    "E_INVALID_CONTROL_QUBIT": "Invalid control qubit. Must be >=0 and <numQubits.",
    "E_INVALID_STATE_INDEX": "Invalid state index. Must be >=0 and <2^numQubits.",
    "E_INVALID_AMP_INDEX": "Invalid amplitude index. Must be >=0 and <2^numQubits.",
    "E_INVALID_NUM_AMPS": "Invalid number of amplitudes. Must be >=0 and <=2^numQubits.",
    "E_INVALID_OFFSET_NUM_AMPS_QUREG": "More amplitudes given than exist in the statevector from the given starting index.",
    "E_TARGET_IS_CONTROL": "Control qubit cannot equal target qubit.",
    "E_TARGET_IN_CONTROLS": "Control qubits cannot include target qubit.",
    "E_CONTROL_TARGET_COLLISION": "Control and target qubits must be disjoint.",
    "E_QUBITS_NOT_UNIQUE": "The qubits must be unique.",
    "E_TARGETS_NOT_UNIQUE": "The target qubits must be unique.",
    "E_CONTROLS_NOT_UNIQUE": "The control qubits should be unique.",
    "E_INVALID_NUM_QUBITS": "Invalid number of qubits. Must be >0 and <=numQubits.",
    "E_INVALID_NUM_TARGETS": "Invalid number of target qubits. Must be >0 and <=numQubits.",
    "E_INVALID_NUM_CONTROLS": "Invalid number of control qubits. Must be >0 and <numQubits.",
    "E_NON_UNITARY_MATRIX": "Matrix is not unitary.",
    "E_NON_UNITARY_COMPLEX_PAIR": "Compact matrix formed by given complex numbers is not unitary.",
    "E_INVALID_QUBIT_OUTCOME": "Invalid measurement outcome -- must be either 0 or 1.",
    "E_MISMATCHING_QUREG_DIMENSIONS": "Dimensions of the qubit registers don't match.",
    "E_MISMATCHING_QUREG_TYPES": "Registers must both be state-vectors or both be density matrices.",
    "E_DEFINED_ONLY_FOR_STATEVECS": "Operation valid only for state-vectors.",
    "E_INVALID_CONTROLS_BIT_STATE": "The state of the control qubits must be a bit sequence (0s and 1s).",
    "E_INVALID_UNITARY_SIZE": "The matrix size does not match the number of target qubits.",
    "E_NUM_AMPS_EXCEED_TYPE": "Too many qubits (max of log2(SIZE_MAX)). Cannot store the number of amplitudes per-node in the size_t type.",
    "E_NOT_FINITE": "Invalid input. Matrix, diagonal-operator and amplitude values must be finite (no NaN or Inf).",
    "E_CANNOT_OPEN_FILE": "Could not open file (%s).",
    "E_INVALID_PAULI_CODE": "Invalid Pauli code. Codes must be 0 (or PAULI_I), 1 (PAULI_X), 2 (PAULI_Y) or 3 (PAULI_Z) to indicate the identity, X, Y and Z operators respectively.",
    "E_INVALID_NUM_SUM_TERMS": "Invalid number of terms in the Pauli sum. The number of terms must be >0.",
    "E_INVALID_PAULI_HAMIL_PARAMS": "The number of qubits and terms in the PauliHamil must be strictly positive.",
    "E_INVALID_PAULI_HAMIL_FILE_PARAMS": "The number of qubits and terms in the PauliHamil file (%s) must be strictly positive.",
    "E_CANNOT_PARSE_PAULI_HAMIL_FILE_COEFF": "Failed to parse the next expected term coefficient in PauliHamil file (%s).",
    "E_CANNOT_PARSE_PAULI_HAMIL_FILE_PAULI": "Failed to parse the next expected Pauli code in PauliHamil file (%s).",
    "E_INVALID_PAULI_HAMIL_FILE_PAULI_CODE": "The PauliHamil file (%s) contained an invalid pauli code (%d). Codes must be 0 (or PAULI_I), 1 (PAULI_X), 2 (PAULI_Y) or 3 (PAULI_Z) to indicate the identity, X, Y and Z operators respectively.",
    "E_MISMATCHING_PAULI_HAMIL_QUREG_NUM_QUBITS": "The PauliHamil must act on the same number of qubits as exist in the Qureg.",
    "E_INVALID_TROTTER_ORDER": "The Trotterisation order must be 1, or an even number (for higher-order Suzuki symmetrized expansions).",
    "E_INVALID_TROTTER_REPS": "The number of Trotter repetitions must be >=1.",
}


def _raise(code: str, func: str, *fmt):
    msg = ERROR_MESSAGES[code]
    if fmt:
        msg = msg % fmt
    raise QuESTError(f"{func}: {msg}")


def validate_num_qubits(num_qubits: int, func: str):
    """validateNumQubitsInQureg (:345-355) for one device."""
    if num_qubits <= 0:
        _raise("E_INVALID_NUM_CREATE_QUBITS", func)
    if num_qubits > 62:
        _raise("E_NUM_AMPS_EXCEED_TYPE", func)


def validate_state_index(qureg, state_ind: int, func: str):
    """validateStateIndex (:373-376)."""
    if state_ind < 0 or state_ind >= (1 << qureg.num_qubits_represented):
        _raise("E_INVALID_STATE_INDEX", func)


def validate_amp_index(qureg, amp_ind: int, func: str):
    """validateAmpIndex (:378-381)."""
    if amp_ind < 0 or amp_ind >= (1 << qureg.num_qubits_represented):
        _raise("E_INVALID_AMP_INDEX", func)


def validate_num_amps(qureg, start: int, num_amps: int, func: str):
    """validateNumAmps (:383-387)."""
    validate_amp_index(qureg, start, func)
    if num_amps < 0 or num_amps > qureg.num_amps_total:
        _raise("E_INVALID_NUM_AMPS", func)
    if num_amps + start > qureg.num_amps_total:
        _raise("E_INVALID_OFFSET_NUM_AMPS_QUREG", func)


def validate_target(qureg, target: int, func: str):
    """validateTarget (:396-398)."""
    if target < 0 or target >= qureg.num_qubits_represented:
        _raise("E_INVALID_TARGET_QUBIT", func)


def validate_control(qureg, control: int, func: str):
    """validateControl (:400-402)."""
    if control < 0 or control >= qureg.num_qubits_represented:
        _raise("E_INVALID_CONTROL_QUBIT", func)


def validate_control_target(qureg, control: int, target: int, func: str):
    """validateControlTarget (:404-408)."""
    validate_target(qureg, target, func)
    validate_control(qureg, control, func)
    if control == target:
        _raise("E_TARGET_IS_CONTROL", func)


def validate_unique_targets(qureg, qb1: int, qb2: int, func: str):
    """validateUniqueTargets (:410-414)."""
    validate_target(qureg, qb1, func)
    validate_target(qureg, qb2, func)
    if qb1 == qb2:
        _raise("E_TARGETS_NOT_UNIQUE", func)


def validate_num_targets(qureg, num_targets: int, func: str):
    """validateNumTargets (:416-418)."""
    if num_targets < 1 or num_targets > qureg.num_qubits_represented:
        _raise("E_INVALID_NUM_TARGETS", func)


def validate_num_controls(qureg, num_controls: int, func: str):
    """validateNumControls (:420-422): note the strict < numQubits."""
    if num_controls < 1 or num_controls >= qureg.num_qubits_represented:
        _raise("E_INVALID_NUM_CONTROLS", func)


def validate_multi_targets(qureg, targets: Sequence[int], func: str):
    """validateMultiTargets (:424-430)."""
    validate_num_targets(qureg, len(targets), func)
    for q in targets:
        validate_target(qureg, q, func)
    if len(set(targets)) != len(targets):
        _raise("E_TARGETS_NOT_UNIQUE", func)


def validate_multi_controls(qureg, controls: Sequence[int], func: str):
    """validateMultiControls (:432-438)."""
    validate_num_controls(qureg, len(controls), func)
    for q in controls:
        validate_control(qureg, q, func)
    if len(set(controls)) != len(controls):
        _raise("E_CONTROLS_NOT_UNIQUE", func)


def validate_multi_controls_target(qureg, controls: Sequence[int],
                                   target: int, func: str):
    """validateMultiControlsTarget (:448-453)."""
    validate_target(qureg, target, func)
    validate_multi_controls(qureg, controls, func)
    if target in set(controls):
        _raise("E_TARGET_IN_CONTROLS", func)


def validate_multi_controls_targets(qureg, controls: Sequence[int],
                                    targets: Sequence[int], func: str):
    """validateMultiControlsMultiTargets (:455-462)."""
    validate_multi_targets(qureg, targets, func)
    if len(controls) > 0:
        validate_multi_controls(qureg, controls, func)
    if set(controls) & set(targets):
        _raise("E_CONTROL_TARGET_COLLISION", func)


def validate_control_states(controls, control_states, func: str):
    """validateControlState (:464-467)."""
    if len(control_states) != len(controls):
        _raise("E_INVALID_CONTROLS_BIT_STATE", func)
    for s in control_states:
        if s not in (0, 1):
            _raise("E_INVALID_CONTROLS_BIT_STATE", func)


def validate_finite(values, func: str):
    """Reject NaN/Inf in user-supplied numeric payloads."""
    arr = np.asarray(values)
    if arr.dtype == object or not np.issubdtype(arr.dtype, np.number):
        return
    if not np.all(np.isfinite(arr)):
        _raise("E_NOT_FINITE", func)


def validate_matrix_size(u, num_targets: int, func: str):
    """Part of validateMultiQubitMatrix (:492-496), plus finiteness."""
    m = np.asarray(u, dtype=np.complex128)
    dim = 1 << num_targets
    if m.shape != (dim, dim):
        _raise("E_INVALID_UNITARY_SIZE", func)
    validate_finite(m, func)


def validate_unitary(u, num_targets: int, func: str):
    """Unitarity to REAL_EPS (macro_isMatrixUnitary,
    QuEST_validation.c:232-258)."""
    validate_matrix_size(u, num_targets, func)
    m = np.asarray(u, dtype=np.complex128)
    if not np.allclose(m @ m.conj().T, np.eye(m.shape[0]),
                       atol=64 * validation_eps()):
        _raise("E_NON_UNITARY_MATRIX", func)


def validate_unitary_complex_pair(alpha, beta, func: str):
    """The compactUnitary check, with the API's 64*eps slack."""
    if abs(abs(alpha) ** 2 + abs(beta) ** 2 - 1) > 64 * validation_eps():
        _raise("E_NON_UNITARY_COMPLEX_PAIR", func)


def validate_state_vector(qureg, func: str):
    """validateStateVecQureg (:511-513)."""
    if qureg.is_density_matrix:
        _raise("E_DEFINED_ONLY_FOR_STATEVECS", func)


def validate_outcome(outcome: int, func: str):
    """validateOutcome (:519-521)."""
    if outcome not in (0, 1):
        _raise("E_INVALID_QUBIT_OUTCOME", func)


def validate_matching_qureg_dims(q1, q2, func: str):
    """validateMatchingQuregDims (:527-529)."""
    if q1.num_qubits_represented != q2.num_qubits_represented:
        _raise("E_MISMATCHING_QUREG_DIMENSIONS", func)


def validate_matching_qureg_types(q1, q2, func: str):
    """validateMatchingQuregTypes (:531-533)."""
    if q1.is_density_matrix != q2.is_density_matrix:
        _raise("E_MISMATCHING_QUREG_TYPES", func)


def validate_file_opened(opened: bool, fn: str, func: str):
    """validateFileOpened (:539-545)."""
    if not opened:
        _raise("E_CANNOT_OPEN_FILE", func, fn)


# ---------------------------------------------------------------------------
# Pauli sums, PauliHamil, Trotter (:595-604, :647-703)
# ---------------------------------------------------------------------------


def validate_pauli_codes(codes, func: str):
    """validatePauliCodes (:595-600)."""
    for c in np.asarray(codes).ravel():
        if int(c) not in (0, 1, 2, 3):
            _raise("E_INVALID_PAULI_CODE", func)


def validate_num_pauli_sum_terms(num_terms: int, func: str):
    """validateNumPauliSumTerms (:602-604)."""
    if num_terms <= 0:
        _raise("E_INVALID_NUM_SUM_TERMS", func)


def validate_hamil_params(num_qubits: int, num_terms: int, func: str):
    """validateHamilParams (:647-649)."""
    if num_qubits <= 0 or num_terms <= 0:
        _raise("E_INVALID_PAULI_HAMIL_PARAMS", func)


def validate_pauli_hamil(hamil, func: str):
    """validatePauliHamil (:651-654)."""
    validate_hamil_params(hamil.num_qubits, hamil.num_sum_terms, func)
    validate_pauli_codes(np.asarray(hamil.pauli_codes).ravel(), func)


def validate_hamil_matches_qureg(hamil, qureg, func: str):
    """validateMatchingQuregPauliHamilDims (:656-658)."""
    if hamil.num_qubits != qureg.num_qubits_represented:
        _raise("E_MISMATCHING_PAULI_HAMIL_QUREG_NUM_QUBITS", func)


def validate_hamil_file_params(num_qubits: int, num_terms: int, fn: str,
                               func: str):
    """validateHamilFileParams (:660-667)."""
    if num_qubits <= 0 or num_terms <= 0:
        _raise("E_INVALID_PAULI_HAMIL_FILE_PARAMS", func, fn)


def validate_hamil_file_coeff_parsed(parsed: bool, fn: str, func: str):
    """validateHamilFileCoeffParsed (:669-677)."""
    if not parsed:
        _raise("E_CANNOT_PARSE_PAULI_HAMIL_FILE_COEFF", func, fn)


def validate_hamil_file_pauli_parsed(parsed: bool, fn: str, func: str):
    """validateHamilFilePauliParsed (:679-687)."""
    if not parsed:
        _raise("E_CANNOT_PARSE_PAULI_HAMIL_FILE_PAULI", func, fn)


def validate_hamil_file_pauli_code(code: int, fn: str, func: str):
    """validateHamilFilePauliCode (:689-697)."""
    if int(code) not in (0, 1, 2, 3):
        _raise("E_INVALID_PAULI_HAMIL_FILE_PAULI_CODE", func, fn, int(code))


def validate_trotter_params(order: int, reps: int, func: str):
    """validateTrotterParams (:699-703)."""
    if order <= 0 or (order % 2 and order != 1):
        _raise("E_INVALID_TROTTER_ORDER", func)
    if reps <= 0:
        _raise("E_INVALID_TROTTER_REPS", func)
