"""Public API: registers, state initialisation and the unitary gates.

The QuEST camelCase surface (QuEST.h) of the ported slices: registers,
state initialisation and reports, ComplexMatrixN and PauliHamil, the
unitary gates and the Pauli rotations.  Every gate
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
from .ops import element as E
from .ops import kernels as K
from .ops.paulis import PAULI_I, PAULI_X, PAULI_Y, PAULI_Z
from .qureg import DiagonalOp, PauliHamil, Qureg

# ---------------------------------------------------------------------------
# Environment (QuEST.h:1851-1939)
# ---------------------------------------------------------------------------

createQuESTEnv = _env.create_quest_env
destroyQuESTEnv = _env.destroy_quest_env
syncQuESTEnv = _env.sync_quest_env
getEnvironmentString = _env.get_environment_string
seedQuEST = _env.seed_quest
seedQuESTDefault = _env.seed_quest_default
syncQuESTSuccess = _env.sync_quest_success
QuESTError = V.QuESTError


def reportQuESTEnv(env: _env.QuESTEnv) -> None:
    """Print execution-environment parameters (QuEST.h:1893)."""
    print(getEnvironmentString(env))


def copyStateToGPU(qureg: Qureg) -> None:
    """No-op: the amplitudes always live on the register's device (the
    reference's GPU backend keeps a host mirror it must sync,
    QuEST_gpu.cu:517-539)."""


def copyStateFromGPU(qureg: Qureg) -> None:
    """No-op: see copyStateToGPU."""


def invalidQuESTInputError(errMsg: str, errFunc: str):
    """The reference's overridable error hook (QuEST.h:5354); in Python
    the equivalent is catching QuESTError."""
    raise V.QuESTError(f"{errFunc}: {errMsg}")


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


def _host_chunks(qureg: Qureg, chunk: int = 1 << 20):
    """The amplitudes as NumPy (2, m) arrays of the register's dtype,
    2^20 at a time."""
    amps = qureg.amps
    for start in range(0, qureg.num_amps_total, chunk):
        yield amps[:, start:start + chunk].cpu().numpy()


def reportState(qureg: Qureg) -> None:
    """Dump the amplitudes to ``state_rank_0.csv`` in the working
    directory, ``real, imag`` header first (QuEST_common.c:229-245; one
    device is rank 0's one chunk)."""
    with open("state_rank_0.csv", "w") as f:
        f.write("real, imag\n")
        for part in _host_chunks(qureg):
            f.writelines(f"{re:.12f}, {im:.12f}\n"
                         for re, im in zip(part[0], part[1]))


def reportStateToScreen(qureg: Qureg, env=None, reportRank: int = 0) -> None:
    """Print every amplitude to stdout (QuEST.h:1289)."""
    from .debug import guard_host_gather

    guard_host_gather(qureg, "reportStateToScreen")
    print("Reporting state from rank 0:")
    for part in _host_chunks(qureg):
        for re, im in zip(part[0], part[1]):
            print(f"{re} {im}")


def reportQuregParams(qureg: Qureg) -> None:
    """Print register metadata (QuEST.h:1297); one device holds all the
    amplitudes."""
    print(f"QUBITS:\nNumber of qubits is {qureg.num_qubits_represented}.")
    print(f"Number of amps is {qureg.num_amps_total}.")
    print(f"Number of amps per rank is {qureg.num_amps_total}.")


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
    # written in place, as the reference writes its chunk
    # (ops/element.set_amp_range); pending fused gates drain first
    E.set_amp_range(qureg.amps, startInd, np.stack([re, im]))


def initStateFromAmps(qureg: Qureg, reals, imags) -> None:
    """Set every amplitude from real and imaginary arrays (QuEST.h:1490;
    state-vectors only, QuEST.c:157-158)."""
    V.validate_state_vector(qureg, "initStateFromAmps")
    _set_all_amps(qureg, reals, imags, "initStateFromAmps")


def setDensityAmps(qureg: Qureg, reals, imags) -> None:
    """Overwrite every element of a density matrix, flattened column-major
    (QuEST_debug.h)."""
    V.validate_density_matrix(qureg, "setDensityAmps")
    _set_all_amps(qureg, reals, imags, "setDensityAmps")


def _set_all_amps(qureg: Qureg, reals, imags, func: str) -> None:
    re = np.asarray(reals, dtype=np.float64).ravel()
    im = np.asarray(imags, dtype=np.float64).ravel()
    if re.size != qureg.num_amps_total or im.size != qureg.num_amps_total:
        raise V.QuESTError(f"{func}: Incorrect number of amplitudes.")
    V.validate_finite(re, func)
    V.validate_finite(im, func)
    qureg.amps = torch.as_tensor(np.stack([re, im]), dtype=qureg.dtype,
                                 device=qureg.device)


def initSparseState(qureg: Qureg, indices, amps) -> None:
    """Initialise from a sparse amplitude list: ``state[indices[k]] =
    amps[k]``, every other amplitude zero (sparse state preparation,
    arXiv:2504.08705).  State-vectors only; pending fused gates are
    dropped, as by any wholesale initialisation."""
    V.validate_state_vector(qureg, "initSparseState")
    _guard_batched_eager(qureg, "initSparseState")
    idx = np.asarray(indices, dtype=np.int64).ravel()
    vals = np.asarray(amps, dtype=np.complex128).ravel()
    if idx.size == 0 or idx.size != vals.size:
        raise V.QuESTError(
            "initSparseState: indices and amps must be non-empty and "
            "equal length.")
    if int(idx.min()) < 0 or int(idx.max()) >= qureg.num_amps_total:
        raise V.QuESTError("initSparseState: Invalid amplitude index.")
    if np.unique(idx).size != idx.size:
        raise V.QuESTError("initSparseState: duplicate amplitude indices.")
    V.validate_finite(vals.real, "initSparseState")
    V.validate_finite(vals.imag, "initSparseState")
    qureg.amps = K.init_sparse_state(qureg.num_amps_total, idx, vals.real,
                                     vals.imag, qureg.dtype, qureg.device)


def initSparseClusteredState(qureg: Qureg, bases, blocks) -> None:
    """Initialise a sparse clustered state (arXiv:2504.08705): the nonzero
    amplitudes sit in contiguous blocks, ``state[bases[c] + k] =
    blocks[c][k]``; expands to a flat list for initSparseState."""
    bl = list(blocks)
    bs = np.asarray(bases, dtype=np.int64).ravel()
    if bs.size == 0 or bs.size != len(bl):
        raise V.QuESTError(
            "initSparseClusteredState: bases and blocks must be "
            "non-empty and equal length.")
    idx_parts, val_parts = [], []
    for base, block in zip(bs, bl):
        v = np.asarray(block, dtype=np.complex128).ravel()
        if v.size == 0:
            raise V.QuESTError(
                "initSparseClusteredState: empty amplitude block.")
        idx_parts.append(int(base) + np.arange(v.size, dtype=np.int64))
        val_parts.append(v)
    initSparseState(qureg, np.concatenate(idx_parts),
                    np.concatenate(val_parts))


def cloneQureg(targetQureg: Qureg, copyQureg: Qureg) -> None:
    """Overwrite targetQureg with a copy of copyQureg (QuEST.h:1559)."""
    V.validate_matching_qureg_types(targetQureg, copyQureg, "cloneQureg")
    V.validate_matching_qureg_dims(targetQureg, copyQureg, "cloneQureg")
    targetQureg.amps = copyQureg.amps.to(
        device=targetQureg.device, dtype=targetQureg.dtype, copy=True)


# ---------------------------------------------------------------------------
# ComplexMatrixN (QuEST.h:721-764): host NumPy complex matrices
# ---------------------------------------------------------------------------


def createComplexMatrixN(numQubits: int) -> np.ndarray:
    """Allocate a 2^N x 2^N complex matrix of zeros (QuEST.h:721)."""
    V.validate_num_qubits(numQubits, "createComplexMatrixN")
    dim = 1 << numQubits
    return np.zeros((dim, dim), dtype=np.complex128)


def destroyComplexMatrixN(matrix) -> None:
    """Free a ComplexMatrixN (QuEST.h:739): a host array, nothing to
    free."""


def initComplexMatrixN(m: np.ndarray, reals, imags) -> None:
    """Fill a ComplexMatrixN from real and imaginary nested lists
    (QuEST.h:764)."""
    m[...] = (np.asarray(reals, dtype=np.float64)
              + 1j * np.asarray(imags, np.float64))


def getStaticComplexMatrixN(reals, imags) -> np.ndarray:
    return (np.asarray(reals, dtype=np.float64)
            + 1j * np.asarray(imags, np.float64))


# ---------------------------------------------------------------------------
# PauliHamil (QuEST.h:802-897)
# ---------------------------------------------------------------------------


def createPauliHamil(numQubits: int, numSumTerms: int) -> PauliHamil:
    """Allocate a PauliHamil (pauli codes + term coefficients)
    (QuEST.h:802)."""
    V.validate_hamil_params(numQubits, numSumTerms, "createPauliHamil")
    return PauliHamil(numQubits, numSumTerms)


def destroyPauliHamil(hamil: PauliHamil) -> None:
    """Free a PauliHamil (QuEST.h:810): host arrays, nothing to free."""


def createPauliHamilFromFile(filename: str) -> PauliHamil:
    """Text format: per line 'coeff code_0 code_1 ... code_{n-1}'
    (reference parser, QuEST.c:1405-1488; file-specific error codes from
    QuEST_validation.c:539-545, 660-697)."""
    func = "createPauliHamilFromFile"
    try:
        with open(filename) as f:
            lines = [ln.split() for ln in f if ln.strip()]
    except OSError:
        V.validate_file_opened(False, filename, func)
    num_qubits = len(lines[0]) - 1 if lines else 0
    num_terms = len(lines)
    V.validate_hamil_file_params(num_qubits, num_terms, filename, func)
    h = PauliHamil(num_qubits, num_terms)
    for t, toks in enumerate(lines):
        V.validate_hamil_file_pauli_parsed(len(toks) == num_qubits + 1,
                                           filename, func)
        try:
            h.term_coeffs[t] = float(toks[0])
        except ValueError:
            V.validate_hamil_file_coeff_parsed(False, filename, func)
        codes = []
        for x in toks[1:]:
            try:
                codes.append(int(x))
            except ValueError:
                V.validate_hamil_file_pauli_parsed(False, filename, func)
        for c in codes:
            V.validate_hamil_file_pauli_code(c, filename, func)
        h.pauli_codes[t, :] = codes
    return h


def initPauliHamil(hamil: PauliHamil, coeffs, codes) -> None:
    """Fill a PauliHamil from coefficients and pauli codes (QuEST.h:897)."""
    V.validate_hamil_params(hamil.num_qubits, hamil.num_sum_terms,
                            "initPauliHamil")
    codes = np.asarray(codes).reshape(hamil.num_sum_terms, hamil.num_qubits)
    V.validate_pauli_codes(codes.ravel(), "initPauliHamil")
    hamil.term_coeffs[:] = np.asarray(coeffs, dtype=np.float64)
    hamil.pauli_codes[...] = codes


def reportPauliHamil(hamil: PauliHamil) -> None:
    """Print a PauliHamil in the reference text format (QuEST.h:1321)."""
    for t in range(hamil.num_sum_terms):
        codes = " ".join(str(int(c)) for c in hamil.pauli_codes[t])
        print(f"{hamil.term_coeffs[t]:g}\t{codes}")


# ---------------------------------------------------------------------------
# DiagonalOp (QuEST.h:977-1185)
# ---------------------------------------------------------------------------


def createDiagonalOp(numQubits: int, env: _env.QuESTEnv) -> DiagonalOp:
    """Allocate a diagonal operator of zeros (QuEST.h:977)."""
    V.validate_num_qubits_in_diag_op(numQubits, env.num_ranks,
                                     "createDiagonalOp")
    return DiagonalOp(numQubits, env)


def destroyDiagonalOp(op: DiagonalOp, env=None) -> None:
    """Free a DiagonalOp (QuEST.h:991): its tensors go with the object."""


def syncDiagonalOp(op: DiagonalOp) -> None:
    """No-op: the reference mirrors host arrays into op.deviceOperator
    (QuEST.h:297); these always live on the env's device."""


def _diag_vector(vals, op: DiagonalOp, func: str) -> torch.Tensor:
    arr = np.asarray(vals, dtype=np.float64).ravel()
    if arr.size != 1 << op.num_qubits:
        raise V.QuESTError(f"{func}: Incorrect number of elements.")
    V.validate_finite(arr, func)
    return torch.as_tensor(arr, dtype=op.real.dtype, device=op.real.device)


def initDiagonalOp(op: DiagonalOp, reals, imags) -> None:
    """Fill a DiagonalOp from real/imag arrays of 2^n values (QuEST.h:1039;
    unlike the JAX package, arrays of another size are refused)."""
    op.real = _diag_vector(reals, op, "initDiagonalOp")
    op.imag = _diag_vector(imags, op, "initDiagonalOp")


def setDiagonalOpElems(op: DiagonalOp, startInd: int, reals, imags,
                       numElems: int) -> None:
    """Overwrite a contiguous range of diagonal-operator elements in
    place (QuEST.h:1185)."""
    reals = np.asarray(reals, dtype=np.float64)[:numElems]
    imags = np.asarray(imags, dtype=np.float64)[:numElems]
    V.validate_num_elems(op, startInd, numElems, "setDiagonalOpElems")
    V.validate_finite(reals, "setDiagonalOpElems")
    V.validate_finite(imags, "setDiagonalOpElems")
    for vec, vals in ((op.real, reals), (op.imag, imags)):
        vec[startInd:startInd + numElems] = torch.as_tensor(
            vals, dtype=vec.dtype, device=vec.device)


def initDiagonalOpFromPauliHamil(op: DiagonalOp, hamil: PauliHamil) -> None:
    """An all-I/Z Hamiltonian as its diagonal, sum_t c_t prod_q
    (-1)^{z_q(d)}, computed on the device (agnostic_
    initDiagonalOpFromPauliHamil, QuEST_cpu.c:4188-4227)."""
    V.validate_diag_pauli_hamil(op, hamil, "initDiagonalOpFromPauliHamil")
    op.real = K.diag_from_z_hamil(
        hamil.pauli_codes, hamil.term_coeffs, num_qubits=op.num_qubits,
        dtype=op.real.dtype, device=op.real.device)
    op.imag = torch.zeros_like(op.real)


def createDiagonalOpFromPauliHamilFile(filename: str,
                                       env: _env.QuESTEnv) -> DiagonalOp:
    """A diagonal operator from an all-Z PauliHamil file (QuEST.h:1137)."""
    hamil = createPauliHamilFromFile(filename)
    op = DiagonalOp(hamil.num_qubits, env)
    initDiagonalOpFromPauliHamil(op, hamil)
    return op


# ---------------------------------------------------------------------------
# Dispatch helpers (QuEST.c:177-346 twin-op pattern)
# ---------------------------------------------------------------------------


def _sv_n(qureg: Qureg) -> int:
    return qureg.num_qubits_in_state_vec


def _guard_batched_eager(qureg, what: str) -> None:
    """A BatchedQureg's (B, 2, 2^n) bank flows only through the fused
    drain and the batch helpers: the eager single-register ops would
    misread the leading batch axis, so falling out of the capture path
    is a structured error, never a wrong answer."""
    if getattr(qureg, "batch_size", 0):
        raise V.QuESTError(
            f"{what}: the operation fell out of the fused capture path, "
            "and a BatchedQureg bank has no eager scalar dispatch — keep "
            "gates within fusion limits (<= "
            f"{_fusion.FUSION_MAX_GATE_QUBITS} qubits) or use the "
            "quest_tpu_torch.batch helpers")


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
    _guard_batched_eager(qureg, "_dispatch_matrix")
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
    _guard_batched_eager(qureg, "_apply_diag")
    for t, c, conj in _twins(qureg, targets, controls):
        d = CX.conj(stacked) if conj else stacked
        qureg.amps = K.apply_diagonal(qureg.amps, d, num_qubits=_sv_n(qureg),
                                      targets=t, controls=c,
                                      control_states=control_states)


def _apply_not(qureg, targets, controls, control_states=()):
    """NOTs are pure index-bit flips."""
    if _fusion.capture_not(qureg, targets, controls, control_states):
        return
    _guard_batched_eager(qureg, "_apply_not")
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


def multiControlledPhaseShift(qureg: Qureg, controlQubits: Sequence[int],
                              angle: float) -> None:
    """Phase on the all-ones state of the listed qubits (QuEST.h:1681);
    the list's length replaces the C API's count argument."""
    qubits = [int(q) for q in controlQubits]
    V.validate_multi_qubits(qureg, qubits, "multiControlledPhaseShift")
    _apply_diag(qureg, G.phase_shift_diag(angle), (qubits[-1],),
                tuple(qubits[:-1]))
    qureg.qasm_log.phase_shift(float(angle), tuple(qubits[:-1]), qubits[-1])


def multiControlledPhaseFlip(qureg: Qureg,
                             controlQubits: Sequence[int]) -> None:
    """Phase flip of the all-ones state of the listed qubits
    (QuEST.h:1768)."""
    qubits = [int(q) for q in controlQubits]
    V.validate_multi_qubits(qureg, qubits, "multiControlledPhaseFlip")
    _apply_diag(qureg, G.Z_DIAG, (qubits[-1],), tuple(qubits[:-1]))
    qureg.qasm_log.gate("z", tuple(qubits[:-1]), qubits[-1])


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


class Vector:
    """3-vector for rotateAroundAxis (QuEST.h:198)."""

    def __init__(self, x: float, y: float, z: float):
        self.x, self.y, self.z = float(x), float(y), float(z)


def _axis_vec(axis):
    if hasattr(axis, "x"):
        return (float(axis.x), float(axis.y), float(axis.z))
    ax = np.asarray(axis, dtype=np.float64)
    return (float(ax[0]), float(ax[1]), float(ax[2]))


def rotateAroundAxis(qureg: Qureg, rotQubit: int, angle: float,
                     axis) -> None:
    """Rotation by ``angle`` around a Bloch axis (a Vector or an (x, y, z)
    sequence, normalised here) (QuEST.h:2327)."""
    V.validate_target(qureg, rotQubit, "rotateAroundAxis")
    ax = _axis_vec(axis)
    V.validate_unit_vector(*ax, "rotateAroundAxis")
    m = G.rotate_around_axis_matrix(angle, ax)
    _apply_unitary(qureg, m, (rotQubit,))
    qureg.qasm_log.unitary_2x2(m, (), rotQubit)


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


def controlledRotateAroundAxis(qureg, controlQubit, targetQubit, angle,
                               axis) -> None:
    """Controlled rotation around a Bloch axis (QuEST.h:2486)."""
    V.validate_control_target(qureg, controlQubit, targetQubit,
                              "controlledRotateAroundAxis")
    ax = _axis_vec(axis)
    V.validate_unit_vector(*ax, "controlledRotateAroundAxis")
    m = G.rotate_around_axis_matrix(angle, ax)
    _apply_unitary(qureg, m, (targetQubit,), (controlQubit,))
    qureg.qasm_log.unitary_2x2(m, (controlQubit,), targetQubit)


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
    _guard_batched_eager(qureg, "swapGate")
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


# ---------------------------------------------------------------------------
# Pauli rotations (QuEST.h:3912-4138)
# ---------------------------------------------------------------------------


def multiRotateZ(qureg: Qureg, qubits: Sequence[int], angle: float) -> None:
    """Rotation generated by a product of Z operators (parity phase)
    (QuEST.h:3912)."""
    qubits, angle = [int(q) for q in qubits], float(angle)
    V.validate_multi_targets(qureg, qubits, "multiRotateZ")
    _apply_parity_phase(qureg, angle, tuple(qubits), ())
    qureg.qasm_log.comment(
        f"multiRotateZ(angle={angle:g}) on qubits {qubits}")


def multiControlledMultiRotateZ(qureg, controlQubits, targetQubits,
                                angle) -> None:
    """Multi-controlled Z-product rotation (QuEST.h:4037)."""
    controls, targets = list(controlQubits), list(targetQubits)
    V.validate_multi_controls_targets(qureg, controls, targets,
                                      "multiControlledMultiRotateZ")
    _apply_parity_phase(qureg, angle, tuple(targets), tuple(controls))
    qureg.qasm_log.comment(f"multiControlledMultiRotateZ(angle={angle:g}) "
                           f"ctrls {controls} targs {targets}")


def _apply_parity_phase(qureg, angle, qubits, controls):
    """The parity phase on the ket qubits and, on a density matrix, its
    conjugate on the bra qubits.  Reading ``qureg.amps`` drains pending
    fused gates first."""
    _guard_batched_eager(qureg, "_apply_parity_phase")
    qureg.amps = K.apply_parity_phase(qureg.amps, angle,
                                      num_qubits=_sv_n(qureg),
                                      qubits=qubits, controls=controls)
    if qureg.is_density_matrix:
        sh = _shift(qureg)
        qureg.amps = K.apply_parity_phase(
            qureg.amps, -angle, num_qubits=_sv_n(qureg),
            qubits=tuple(q + sh for q in qubits),
            controls=tuple(c + sh for c in controls))


def multiRotatePauli(qureg: Qureg, targetQubits, targetPaulis,
                     angle: float) -> None:
    """Rotation generated by a product of Pauli operators (QuEST.h:3967)."""
    targets = [int(t) for t in targetQubits]
    paulis = [int(p) for p in targetPaulis]
    V.validate_multi_targets(qureg, targets, "multiRotatePauli")
    V.validate_pauli_codes(paulis, "multiRotatePauli")
    _multi_rotate_pauli(qureg, targets, paulis, float(angle), controls=())
    qureg.qasm_log.comment(f"multiRotatePauli(angle={angle:g}) on qubits "
                           f"{targets} paulis {paulis}")


def multiControlledMultiRotatePauli(qureg, controlQubits, targetQubits,
                                    targetPaulis, angle) -> None:
    """Multi-controlled Pauli-product rotation (QuEST.h:4138)."""
    controls = [int(c) for c in controlQubits]
    targets = [int(t) for t in targetQubits]
    paulis = [int(p) for p in targetPaulis]
    V.validate_multi_controls_targets(qureg, controls, targets,
                                      "multiControlledMultiRotatePauli")
    V.validate_pauli_codes(paulis, "multiControlledMultiRotatePauli")
    _multi_rotate_pauli(qureg, targets, paulis, float(angle),
                        controls=tuple(controls))
    qureg.qasm_log.comment(
        f"multiControlledMultiRotatePauli(angle={angle:g}) ctrls {controls} "
        f"targs {targets} paulis {paulis}")


def _multi_rotate_pauli(qureg, targets, paulis, angle, controls):
    """Basis-rotate X/Y targets onto Z, multiRotateZ, unrotate
    (statevec_multiRotatePauli, QuEST_common.c:424-462).  The basis gates go
    through the twin-aware helpers, so the density-matrix path follows."""
    z_qubits = []
    for t, p in zip(targets, paulis):
        if p == PAULI_I:
            continue
        z_qubits.append(t)
        if p == PAULI_X:
            _apply_unitary(qureg, G.RY_M90, (t,), controls)
        elif p == PAULI_Y:
            _apply_unitary(qureg, G.RX_P90, (t,), controls)
    if z_qubits:
        _apply_parity_phase(qureg, angle, tuple(z_qubits), controls)
    for t, p in zip(targets, paulis):
        if p == PAULI_X:
            _apply_unitary(qureg, G.RY_M90.conj().T, (t,), controls)
        elif p == PAULI_Y:
            _apply_unitary(qureg, G.RX_P90.conj().T, (t,), controls)
