"""Input validation for the ported API surface.

A copy of the checks the ported API functions call, with the reference's
message text kept VERBATIM (``QuEST_validation.c`` errorMessages table,
:119-197), so error tests written against the JAX package port one for
one.  Errors are raised as ``QuESTError``.  All checks run on the host,
on NumPy values, before any tensor is touched.
"""

from __future__ import annotations

import warnings
from typing import Optional, Sequence

import numpy as np

from .precision import MAX_NUM_REGS_APPLY_ARBITRARY_PHASE, validation_eps


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
    "E_SECOND_ARG_MUST_BE_STATEVEC": "Second argument must be a state-vector.",
    "E_DEFINED_ONLY_FOR_DENSMATRS": "Operation valid only for density matrices.",
    "E_INVALID_PROB": "Probabilities must be in [0, 1].",
    "E_INVALID_ONE_QUBIT_DEPHASE_PROB": "The probability of a single qubit dephase error cannot exceed 1/2, which maximally mixes.",
    "E_INVALID_TWO_QUBIT_DEPHASE_PROB": "The probability of a two-qubit qubit dephase error cannot exceed 3/4, which maximally mixes.",
    "E_INVALID_ONE_QUBIT_DEPOL_PROB": "The probability of a single qubit depolarising error cannot exceed 3/4, which maximally mixes.",
    "E_INVALID_TWO_QUBIT_DEPOL_PROB": "The probability of a two-qubit depolarising error cannot exceed 15/16, which maximally mixes.",
    "E_INVALID_ONE_QUBIT_PAULI_PROBS": "The probability of any X, Y or Z error cannot exceed the probability of no error.",
    "E_CANNOT_FIT_MULTI_QUBIT_MATRIX": "The specified matrix targets too many qubits; the batches of amplitudes to modify cannot all fit in a single distributed node's memory allocation.",
    "E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS": "At least 1 and at most 4 single qubit Kraus operators may be specified.",
    "E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS": "At least 1 and at most 16 two-qubit Kraus operators may be specified.",
    "E_INVALID_NUM_N_QUBIT_KRAUS_OPS": "At least 1 and at most 4*N^2 of N-qubit Kraus operators may be specified.",
    "E_INVALID_KRAUS_OPS": "The specified Kraus map is not a completely positive, trace preserving map.",
    "E_MISMATCHING_NUM_TARGS_KRAUS_SIZE": "Every Kraus operator must be of the same number of qubits as the number of targets.",
    "E_ZERO_VECTOR": "Invalid axis vector. Must be non-zero.",
    "E_INVALID_ELEM_INDEX": "Invalid element index. Must be >=0 and <2^numQubits.",
    "E_INVALID_NUM_ELEMS": "Invalid number of elements. Must be >=0 and <=2^numQubits.",
    "E_INVALID_OFFSET_NUM_ELEMS_DIAG": "More elements given than exist in the diagonal operator from the given starting index.",
    "E_DISTRIB_DIAG_OP_TOO_SMALL": "Too few qubits. The created DiagonalOp must contain at least one element per node used in distributed simulation.",
    "E_MISMATCHING_QUREG_DIAGONAL_OP_SIZE": "The qureg must represent an equal number of qubits as that in the applied diagonal operator.",
    "E_DIAGONAL_OP_NOT_INITIALISED": "The diagonal operator has not been initialised through createDiagonalOperator().",
    "E_PAULI_HAMIL_NOT_DIAGONAL": "The Pauli Hamiltonian contained operators other than PAULI_Z and PAULI_I, and hence cannot be expressed as a diagonal matrix.",
    "E_MISMATCHING_PAULI_HAMIL_DIAGONAL_OP_SIZE": "The Pauli Hamiltonian and diagonal operator have different, incompatible dimensions.",
    "E_INVALID_NUM_SUBREGISTERS": "Invalid number of qubit subregisters, which must be >0 and <=100.",
    "E_INVALID_NUM_PHASE_FUNC_TERMS": "Invalid number of terms in the phase function specified. Must be >0.",
    "E_INVALID_NUM_PHASE_FUNC_OVERRIDES": "Invalid number of phase function overrides specified. Must be >=0, and for single-variable phase functions, <=2^numQubits (the maximum unique binary values of the sub-register). Note that uniqueness of overriding indices is not checked.",
    "E_INVALID_PHASE_FUNC_OVERRIDE_UNSIGNED_INDEX": "Invalid phase function override index, in the UNSIGNED encoding. Must be >=0, and <= the maximum index possible of the corresponding qubit subregister (2^numQubits-1).",
    "E_INVALID_PHASE_FUNC_OVERRIDE_TWOS_COMPLEMENT_INDEX": "Invalid phase function override index, in the TWOS_COMPLEMENT encoding. Must be between (inclusive) -2^(N-1) and +2^(N-1)-1, where N is the number of qubits (including the sign qubit).",
    "E_INVALID_PHASE_FUNC_NAME": "Invalid named phase function, which must be one of {NORM, SCALED_NORM, INVERSE_NORM, SCALED_INVERSE_NORM, PRODUCT, SCALED_PRODUCT, INVERSE_PRODUCT, SCALED_INVERSE_PRODUCT, DISTANCE, SCALED_DISTANCE, INVERSE_DISTANCE, SCALED_INVERSE_DISTANCE}.",
    "E_INVALID_NUM_NAMED_PHASE_FUNC_PARAMS": "Invalid number of parameters passed for the given named phase function. {NORM, PRODUCT, DISTANCE} accept 0 parameters, {INVERSE_NORM, INVERSE_PRODUCT, INVERSE_DISTANCE} accept 1 parameter (the phase at the divergence), {SCALED_NORM, SCALED_INVERSE_NORM, SCALED_PRODUCT} accept 1 parameter (the scaling coefficient), {SCALED_INVERSE_PRODUCT, SCALED_DISTANCE, SCALED_INVERSE_DISTANCE} accept 2 parameters (the coefficient then divergence phase), SCALED_INVERSE_SHIFTED_NORM accepts 2 + (number of sub-registers) parameters (the coefficient, then the divergence phase, followed by the offset for each sub-register), SCALED_INVERSE_SHIFTED_DISTANCE accepts 2 + (number of sub-registers) / 2 parameters (the coefficient, then the divergence phase, followed by the offset for each pair of sub-registers).",
    "E_INVALID_BIT_ENCODING": "Invalid bit encoding. Must be one of {UNSIGNED, TWOS_COMPLEMENT}.",
    "E_INVALID_NUM_QUBITS_TWOS_COMPLEMENT": "A sub-register contained too few qubits to employ TWOS_COMPLEMENT encoding. Must use >1 qubits (allocating one for the sign).",
    "E_NEGATIVE_EXPONENT_WITHOUT_ZERO_OVERRIDE": "The phase function contained a negative exponent which would diverge at zero, but the zero index was not overriden.",
    "E_FRACTIONAL_EXPONENT_WITHOUT_NEG_OVERRIDE": "The phase function contained a fractional exponent, which in TWOS_COMPLEMENT encoding, requires all negative indices are overriden. However, one or more negative indices were not overriden.",
    "E_NEGATIVE_EXPONENT_MULTI_VAR": "The phase function contained an illegal negative exponent. One must instead call applyPhaseFuncOverrides() once for each register, so that the zero index of each register is overriden, independent of the indices of all other registers.",
    "E_FRACTIONAL_EXPONENT_MULTI_VAR": "The phase function contained a fractional exponent, which is illegal in TWOS_COMPLEMENT encoding, since it cannot be (efficiently) checked that all negative indices were overriden. One must instead call applyPhaseFuncOverrides() once for each register, so that each register's negative indices can be overriden, independent of the indices of all other registers.",
    "E_INVALID_NUM_REGS_DISTANCE_PHASE_FUNC": "Phase functions DISTANCE, INVERSE_DISTANCE, SCALED_DISTANCE and SCALED_INVERSE_DISTANCE require a strictly even number of sub-registers.",
}


def _raise(code: str, func: str, *fmt):
    msg = ERROR_MESSAGES[code]
    if fmt:
        msg = msg % fmt
    raise QuESTError(f"{func}: {msg}")


def strict_parity() -> bool:
    """QT_STRICT_VALIDATION=1 escalates the deliberately warn-only code
    E_CANNOT_FIT_MULTI_QUBIT_MATRIX to a QuESTError, so test suites
    ported verbatim from the reference (which require the throw) pass
    unchanged; it also routes measurement through the host RNG
    (ops/measurement.host_path_enabled).  The JAX package's second
    escalation, E_DISTRIB_QUREG_TOO_SMALL, cannot arise on one device."""
    import os

    return os.environ.get("QT_STRICT_VALIDATION") == "1"


def _warn(code: str, func: str):
    if strict_parity():
        _raise(code, func)
    warnings.warn(f"{func}: {ERROR_MESSAGES[code]}", stacklevel=3)


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


def validate_multi_qubits(qureg, qubits: Sequence[int], func: str):
    """validateMultiQubits (:440-446)."""
    if len(qubits) < 1 or len(qubits) > qureg.num_qubits_represented:
        _raise("E_INVALID_NUM_QUBITS", func)
    for q in qubits:
        if q < 0 or q >= qureg.num_qubits_represented:
            _raise("E_INVALID_QUBIT_INDEX", func)
    if len(set(qubits)) != len(qubits):
        _raise("E_QUBITS_NOT_UNIQUE", func)


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


def validate_multi_qubit_matrix_fits_in_node(qureg, num_targets: int,
                                             func: str):
    """validateMultiQubitMatrixFitsInNode (:469-471).  The reference
    rejects a matrix whose 2^numTargets amplitude batches exceed one
    node's chunk; with one rank the batches always fit, and with several
    this warns with the reference's message, as the JAX package does."""
    num_ranks = qureg.env.num_ranks
    if num_ranks > 1 and (1 << num_targets) > qureg.num_amps_total // num_ranks:
        _warn("E_CANNOT_FIT_MULTI_QUBIT_MATRIX", func)


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


def validate_unit_vector(x, y, z, func: str):
    """validateVector (:507-509): the squared magnitude must exceed
    REAL_EPS^2."""
    if (x * x + y * y + z * z) <= validation_eps() ** 2:
        _raise("E_ZERO_VECTOR", func)


def validate_state_vector(qureg, func: str):
    """validateStateVecQureg (:511-513)."""
    if qureg.is_density_matrix:
        _raise("E_DEFINED_ONLY_FOR_STATEVECS", func)


def validate_density_matrix(qureg, func: str):
    """validateDensityMatrQureg (:515-517)."""
    if not qureg.is_density_matrix:
        _raise("E_DEFINED_ONLY_FOR_DENSMATRS", func)


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


def validate_second_qureg_state_vec(q2, func: str):
    """validateSecondQuregStateVec (:535-537)."""
    if q2.is_density_matrix:
        _raise("E_SECOND_ARG_MUST_BE_STATEVEC", func)


def validate_file_opened(opened: bool, fn: str, func: str):
    """validateFileOpened (:539-545)."""
    if not opened:
        _raise("E_CANNOT_OPEN_FILE", func, fn)


# ---------------------------------------------------------------------------
# Decoherence probabilities and Kraus maps (:547-645)
# ---------------------------------------------------------------------------


def validate_prob(prob: float, func: str):
    """validateProb (:547-549)."""
    if prob < 0 or prob > 1:
        _raise("E_INVALID_PROB", func)


def validate_one_qubit_dephase_prob(prob: float, func: str):
    """validateOneQubitDephaseProb (:559-562)."""
    validate_prob(prob, func)
    if prob > 1 / 2.0:
        _raise("E_INVALID_ONE_QUBIT_DEPHASE_PROB", func)


def validate_two_qubit_dephase_prob(prob: float, func: str):
    """validateTwoQubitDephaseProb (:564-567)."""
    validate_prob(prob, func)
    if prob > 3 / 4.0:
        _raise("E_INVALID_TWO_QUBIT_DEPHASE_PROB", func)


def validate_one_qubit_depol_prob(prob: float, func: str):
    """validateOneQubitDepolProb (:569-572)."""
    validate_prob(prob, func)
    if prob > 3 / 4.0:
        _raise("E_INVALID_ONE_QUBIT_DEPOL_PROB", func)


def validate_one_qubit_damping_prob(prob: float, func: str):
    """validateOneQubitDampingProb (:574-577): cap 1, reported under the
    depolarising error code as the reference does."""
    validate_prob(prob, func)
    if prob > 1.0:
        _raise("E_INVALID_ONE_QUBIT_DEPOL_PROB", func)


def validate_two_qubit_depol_prob(prob: float, func: str):
    """validateTwoQubitDepolProb (:579-582)."""
    validate_prob(prob, func)
    if prob > 15 / 16.0:
        _raise("E_INVALID_TWO_QUBIT_DEPOL_PROB", func)


def validate_one_qubit_pauli_probs(px: float, py: float, pz: float,
                                   func: str):
    """validateOneQubitPauliProbs (:584-593)."""
    validate_prob(px, func)
    validate_prob(py, func)
    validate_prob(pz, func)
    prob_no_error = 1 - px - py - pz
    if px > prob_no_error or py > prob_no_error or pz > prob_no_error:
        _raise("E_INVALID_ONE_QUBIT_PAULI_PROBS", func)


def validate_kraus_ops(ops, num_targets: int, func: str):
    """validate{One,Two,Multi}QubitKrausMap (:606-645): operator-count
    bounds per arity, matching dimensions, CPTP to REAL_EPS."""
    max_ops = 1 << (2 * num_targets)
    if len(ops) < 1 or len(ops) > max_ops:
        code = {
            1: "E_INVALID_NUM_ONE_QUBIT_KRAUS_OPS",
            2: "E_INVALID_NUM_TWO_QUBIT_KRAUS_OPS",
        }.get(num_targets, "E_INVALID_NUM_N_QUBIT_KRAUS_OPS")
        _raise(code, func)
    dim = 1 << num_targets
    acc = np.zeros((dim, dim), dtype=np.complex128)
    for op in ops:
        m = np.asarray(op, dtype=np.complex128)
        if m.shape != (dim, dim):
            _raise("E_MISMATCHING_NUM_TARGS_KRAUS_SIZE", func)
        acc += m.conj().T @ m
    if not np.allclose(acc, np.eye(dim), atol=1024 * validation_eps()):
        _raise("E_INVALID_KRAUS_OPS", func)


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


# ---------------------------------------------------------------------------
# Diagonal operators (QuEST_validation.c:361-371, 389-394, 705-751)
# ---------------------------------------------------------------------------


def validate_num_qubits_in_diag_op(num_qubits: int, num_ranks: int,
                                   func: str):
    """validateNumQubitsInDiagOp (:361-371); the per-node size check warns
    as the JAX package's does (it cannot arise on one device)."""
    if num_qubits <= 0:
        _raise("E_INVALID_NUM_CREATE_QUBITS", func)
    if (1 << num_qubits) < num_ranks:
        _warn("E_DISTRIB_DIAG_OP_TOO_SMALL", func)


def validate_num_elems(op, start: int, num_elems: int, func: str):
    """validateNumElems (:389-394)."""
    dim = 1 << op.num_qubits
    if start < 0 or start >= dim:
        _raise("E_INVALID_ELEM_INDEX", func)
    if num_elems < 0 or num_elems > dim:
        _raise("E_INVALID_NUM_ELEMS", func)
    if num_elems + start > dim:
        _raise("E_INVALID_OFFSET_NUM_ELEMS_DIAG", func)


def validate_diag_op_init(op, func: str):
    """validateDiagOpInit (:705-707): the real and imaginary vectors
    exist."""
    if op is None or getattr(op, "real", None) is None \
            or getattr(op, "imag", None) is None:
        _raise("E_DIAGONAL_OP_NOT_INITIALISED", func)


def validate_diag_op_matches_qureg(op, qureg, func: str):
    """validateDiagonalOp (:709-712)."""
    validate_diag_op_init(op, func)
    if op.num_qubits != qureg.num_qubits_represented:
        _raise("E_MISMATCHING_QUREG_DIAGONAL_OP_SIZE", func)


def validate_diag_pauli_hamil(op, hamil, func: str):
    """validateDiagPauliHamil (:714-721): only I/Z terms, matching dims."""
    validate_diag_op_init(op, func)
    validate_hamil_params(hamil.num_qubits, hamil.num_sum_terms, func)
    if op.num_qubits != hamil.num_qubits:
        _raise("E_MISMATCHING_PAULI_HAMIL_DIAGONAL_OP_SIZE", func)
    for c in np.asarray(hamil.pauli_codes).ravel():
        if int(c) not in (0, 3):
            _raise("E_PAULI_HAMIL_NOT_DIAGONAL", func)


def validate_diag_hamil_from_file(hamil, num_ranks: int, func: str):
    """validateDiagPauliHamilFromFile (:723-751)."""
    validate_hamil_params(hamil.num_qubits, hamil.num_sum_terms, func)
    if (1 << hamil.num_qubits) < num_ranks:
        _raise("E_DISTRIB_DIAG_OP_TOO_SMALL", func)
    for c in np.asarray(hamil.pauli_codes).ravel():
        if int(c) not in (0, 3):
            _raise("E_PAULI_HAMIL_NOT_DIAGONAL", func)


# ---------------------------------------------------------------------------
# Phase functions (:753-984)
# ---------------------------------------------------------------------------


def validate_qubit_subregs(qureg, qubits_per_reg: Sequence[Sequence[int]],
                           func: str):
    """validateQubitSubregs (:753-767)."""
    num_regs = len(qubits_per_reg)
    if num_regs <= 0 or num_regs > MAX_NUM_REGS_APPLY_ARBITRARY_PHASE:
        _raise("E_INVALID_NUM_SUBREGISTERS", func)
    flat = []
    for reg in qubits_per_reg:
        if len(reg) <= 0 or len(reg) > qureg.num_qubits_represented:
            _raise("E_INVALID_NUM_QUBITS", func)
        for q in reg:
            if q < 0 or q >= qureg.num_qubits_represented:
                _raise("E_INVALID_QUBIT_INDEX", func)
            flat.append(q)
    if len(set(flat)) != len(flat):
        _raise("E_QUBITS_NOT_UNIQUE", func)


def validate_phase_func_terms(num_qubits: int, encoding: int, coeffs,
                              exponents, override_inds, func: str):
    """validatePhaseFuncTerms (:769-831): term count, negative exponents
    need a zero override, fractional exponents in TWOS_COMPLEMENT need all
    negative indices overriden."""
    exponents = list(exponents)
    if len(exponents) <= 0:
        _raise("E_INVALID_NUM_PHASE_FUNC_TERMS", func)
    has_fraction = any(np.floor(e) != e for e in exponents)
    has_negative = any(e < 0 for e in exponents)
    inds = [int(i) for i in override_inds]
    if has_negative and 0 not in inds:
        _raise("E_NEGATIVE_EXPONENT_WITHOUT_ZERO_OVERRIDE", func)
    if has_fraction and encoding == 1:  # TWOS_COMPLEMENT
        num_neg = 1 << (num_qubits - 1)
        neg_overriden = {(-1 - i) for i in inds if i < 0}
        if len(inds) < num_neg or (
            num_qubits < 16 and any(j not in neg_overriden
                                    for j in range(num_neg))
        ):
            _raise("E_FRACTIONAL_EXPONENT_WITHOUT_NEG_OVERRIDE", func)


def validate_multi_var_phase_func_terms(num_qubits_per_reg, encoding,
                                        exponents_per_reg, func: str):
    """validateMultiVarPhaseFuncTerms (:831-855)."""
    num_regs = len(num_qubits_per_reg)
    if num_regs <= 0 or num_regs > MAX_NUM_REGS_APPLY_ARBITRARY_PHASE:
        _raise("E_INVALID_NUM_SUBREGISTERS", func)
    for exps in exponents_per_reg:
        if len(list(exps)) <= 0:
            _raise("E_INVALID_NUM_PHASE_FUNC_TERMS", func)
    all_exps = [e for exps in exponents_per_reg for e in exps]
    if any(e < 0 for e in all_exps):
        _raise("E_NEGATIVE_EXPONENT_MULTI_VAR", func)
    if encoding == 1 and any(np.floor(e) != e for e in all_exps):
        _raise("E_FRACTIONAL_EXPONENT_MULTI_VAR", func)


def validate_phase_func_overrides(num_regs_qubits, encoding, override_inds,
                                  func: str):
    """validatePhaseFuncOverrides / validateMultiVarPhaseFuncOverrides
    (:857-906): override indices representable per sub-register."""
    num_overrides = len(list(override_inds))
    if len(num_regs_qubits) == 1 and num_overrides > (1 << num_regs_qubits[0]):
        _raise("E_INVALID_NUM_PHASE_FUNC_OVERRIDES", func)
    for ind_tuple in override_inds:
        for nq, ind in zip(num_regs_qubits, ind_tuple):
            if encoding == 0:  # UNSIGNED
                if ind < 0 or ind > (1 << nq) - 1:
                    _raise("E_INVALID_PHASE_FUNC_OVERRIDE_UNSIGNED_INDEX",
                           func)
            else:  # TWOS_COMPLEMENT
                half = 1 << (nq - 1)
                if ind < -half or ind > half - 1:
                    _raise(
                        "E_INVALID_PHASE_FUNC_OVERRIDE_TWOS_COMPLEMENT_INDEX",
                        func)


def validate_phase_func_name(name: int, num_regs: int, num_params: int,
                             func: str):
    """validatePhaseFuncName (:908-959): legal code, per-function parameter
    count, even sub-register count for the DISTANCE family."""
    from .ops import phasefunc as _pf

    if name < 0 or name > 13:
        _raise("E_INVALID_PHASE_FUNC_NAME", func)
    expected = {
        _pf.NORM: 0, _pf.PRODUCT: 0, _pf.DISTANCE: 0,
        _pf.INVERSE_NORM: 1, _pf.INVERSE_PRODUCT: 1, _pf.INVERSE_DISTANCE: 1,
        _pf.SCALED_NORM: 1, _pf.SCALED_PRODUCT: 1, _pf.SCALED_DISTANCE: 1,
        _pf.SCALED_INVERSE_NORM: 2, _pf.SCALED_INVERSE_PRODUCT: 2,
        _pf.SCALED_INVERSE_DISTANCE: 2,
        _pf.SCALED_INVERSE_SHIFTED_NORM: 2 + num_regs,
        _pf.SCALED_INVERSE_SHIFTED_DISTANCE: 2 + num_regs // 2,
    }
    if num_params != expected[name]:
        _raise("E_INVALID_NUM_NAMED_PHASE_FUNC_PARAMS", func)
    if name in (_pf.DISTANCE, _pf.INVERSE_DISTANCE, _pf.SCALED_DISTANCE,
                _pf.SCALED_INVERSE_DISTANCE,
                _pf.SCALED_INVERSE_SHIFTED_DISTANCE) and num_regs % 2:
        _raise("E_INVALID_NUM_REGS_DISTANCE_PHASE_FUNC", func)


def validate_bit_encoding(encoding: int, func: str,
                          num_qubits: Optional[int] = None):
    """validateBitEncoding (:961-969)."""
    if encoding not in (0, 1):
        _raise("E_INVALID_BIT_ENCODING", func)
    if encoding == 1 and num_qubits is not None and num_qubits <= 1:
        _raise("E_INVALID_NUM_QUBITS_TWOS_COMPLEMENT", func)


def validate_multi_reg_bit_encoding(num_qubits_per_reg, encoding: int,
                                    func: str):
    """validateMultiRegBitEncoding (:971-981)."""
    if encoding not in (0, 1):
        _raise("E_INVALID_BIT_ENCODING", func)
    if encoding == 1:
        for nq in num_qubits_per_reg:
            if nq <= 1:
                _raise("E_INVALID_NUM_QUBITS_TWOS_COMPLEMENT", func)
