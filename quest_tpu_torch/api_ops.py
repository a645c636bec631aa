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
from . import telemetry as _telemetry
from . import validation as V
from .api import (PAULI_I, _default_route, _shift, _sv_n, hadamard,
                  multiRotatePauli, swapGate)
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
from .parallel import composites as COMP
from .parallel import dist as PAR
from .parallel import sharded as SH
from .qureg import DiagonalOp, PauliHamil, Qureg
from .rng import GLOBAL_RNG


def _quad() -> bool:
    """Precision 4: route reductions through double-double accumulation."""
    return get_precision() == 4


def _sharded_amps(qureg):
    """The canonical amplitudes when the register is sharded (None
    otherwise).  At quad precision the sharded reads take each shard's
    share of the double-double partials (parallel/sharded.py)."""
    amps = qureg.amps
    if not isinstance(amps, SH.ShardedAmps):
        return None
    return amps


def _spans_mesh(qureg) -> bool:
    """The register's amplitudes are split over the env's shards (a
    register smaller than the mesh is replicated)."""
    return qureg.is_sharded


def _explicit_sharded(qureg) -> bool:
    """Route to the explicit sharded composites (parallel/composites.py):
    the register spans the mesh and the explicit exchange routes are on
    (the default).  Off, the composites that have an explicit form take
    the default route (gather, the ordinary op, split), as eager gates
    do (quest_tpu/api_ops.py:533-551)."""
    return PAR.explicit_dist_enabled() and _spans_mesh(qureg)


def _whole(qureg):
    """A sharded register's canonical state gathered onto one device (the
    default route's read, counted as that route)."""
    amps = qureg.amps
    PAR.record_route("default")
    return amps.mesh.gather(amps.shards)


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
    sh = _sharded_amps(qureg)
    if sh is not None:
        pair = SH.amp_pair(sh, int(index)).cpu()
    else:
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        pair = SH.amp_pair(sh, int(row + col * dim)).cpu()
    else:
        pair = E.get_amp_pair(qureg.amps, int(row + col * dim)).cpu()
    return complex(float(pair[0]), float(pair[1]))


def calcProbOfOutcome(qureg: Qureg, measureQubit: int, outcome: int) -> float:
    """Probability of measuring the given outcome of one qubit
    (QuEST.h:3047)."""
    V.validate_target(qureg, measureQubit, "calcProbOfOutcome")
    V.validate_outcome(outcome, "calcProbOfOutcome")
    sh = _sharded_amps(qureg)
    if sh is not None:
        if _quad():
            return SH.prob_of_outcome_quad(
                sh, measureQubit, outcome, qureg.is_density_matrix,
                qureg.num_qubits_represented)
        if qureg.is_density_matrix:
            return float(SH.prob_of_outcome_density(
                sh, qureg.num_qubits_represented, measureQubit, outcome))
        return float(SH.prob_of_outcome_statevec(sh, measureQubit, outcome))
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        if qureg.is_density_matrix:
            p = SH.all_outcomes_density(sh, qureg.num_qubits_represented,
                                        tuple(qubits))
        else:
            p = SH.all_outcomes_statevec(sh, tuple(qubits))
        return p.cpu().numpy()
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
    if qureg.is_sharded:
        bits = [(qubit, outcome)]
        if qureg.is_density_matrix:
            bits.append((qubit + qureg.num_qubits_represented, outcome))
        qureg.amps = SH.collapse(qureg.amps, float(prob), bits,
                                 qureg.is_density_matrix)
        return
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
    _telemetry.inc("measurement_shots_total")
    if M.host_path_enabled():
        zero_prob = calcProbOfOutcome(qureg, measureQubit, 0)
        outcome = _generate_measurement_outcome(zero_prob)
        prob = zero_prob if outcome == 0 else 1 - zero_prob
        _collapse(qureg, measureQubit, outcome, prob)
        qureg.qasm_log.measure(measureQubit)
        return outcome, prob
    key, shot = M.KEYS.next_shots()
    sh = _sharded_amps(qureg)
    if sh is not None:
        u = M.thresholds(key, shot, 1, sh.dtype, sh.device)[0]
        qureg.amps, outcome, prob = SH.measure_once(
            sh, u, num_qubits=qureg.num_qubits_represented,
            target=measureQubit, is_density=qureg.is_density_matrix,
            quad=_quad())
        qureg.qasm_log.measure(measureQubit)
        outs, probs = M.to_host(outcome[None], prob[None])
        return outs[0], probs[0]
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
    # (the host path above counts per measureWithStats call)
    _telemetry.inc("measurement_shots_total", len(qubits))
    key, shot = M.KEYS.next_shots(len(qubits))
    sh = _sharded_amps(qureg)
    if sh is not None:
        us = M.thresholds(key, shot, len(qubits), sh.dtype, sh.device)
        outs, probs = [], []
        for j, q in enumerate(qubits):
            sh, o, p = SH.measure_once(
                sh, us[j], num_qubits=qureg.num_qubits_represented,
                target=q, is_density=qureg.is_density_matrix, quad=_quad())
            outs.append(o)
            probs.append(p)
        qureg.amps = sh
        for q in qubits:
            qureg.qasm_log.measure(q)
        return M.to_host(torch.stack(outs), torch.stack(probs))
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        if _quad():
            return SH.total_prob_quad(sh, qureg.is_density_matrix,
                                      qureg.num_qubits_represented)
        if qureg.is_density_matrix:
            return float(SH.total_prob_density(
                sh, qureg.num_qubits_represented))
        return float(PAR.total_prob_sharded(sh))
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
    sh = _sharded_amps(bra)
    if sh is not None:
        if _quad():
            return complex(*SH.inner_product_quad(sh, ket.amps))
        r = SH.inner_product(sh, ket.amps).cpu()
        return complex(float(r[0]), float(r[1]))
    ip = C.calc_inner_product_quad if _quad() else C.calc_inner_product
    r = ip(bra.amps, ket.amps).cpu()
    return complex(float(r[0]), float(r[1]))


def calcDensityInnerProduct(rho1: Qureg, rho2: Qureg) -> float:
    """Hilbert-Schmidt inner product Tr(rho1^dag rho2) of two density
    matrices (QuEST.h:3299)."""
    V.validate_density_matrix(rho1, "calcDensityInnerProduct")
    V.validate_density_matrix(rho2, "calcDensityInnerProduct")
    V.validate_matching_qureg_dims(rho1, rho2, "calcDensityInnerProduct")
    sh = _sharded_amps(rho1)
    if sh is not None:
        if _quad():
            return SH.density_inner_product_quad(sh, rho2.amps)
        return float(SH.density_inner_product(sh, rho2.amps))
    return float(C.calc_density_inner_product(rho1.amps, rho2.amps,
                                              quad=_quad()))


def calcPurity(qureg: Qureg) -> float:
    """Purity Tr(rho^2) of a density matrix (QuEST.h:3692)."""
    V.validate_density_matrix(qureg, "calcPurity")
    sh = _sharded_amps(qureg)
    if sh is not None:
        return SH.purity_quad(sh) if _quad() else float(SH.purity(sh))
    return float(C.calc_purity(qureg.amps, quad=_quad()))


def calcFidelity(qureg: Qureg, pureState: Qureg) -> float:
    """Fidelity of a register against a pure reference state
    (QuEST.h:3724): <psi|rho|psi>, or |<psi|phi>|^2."""
    V.validate_second_qureg_state_vec(pureState, "calcFidelity")
    V.validate_matching_qureg_dims(qureg, pureState, "calcFidelity")
    sh = _sharded_amps(qureg)
    if sh is not None:
        if not qureg.is_density_matrix:
            if _quad():
                re, im = SH.inner_product_quad(sh, pureState.amps)
                return float(re ** 2 + im ** 2)
            r = SH.inner_product(sh, pureState.amps).cpu()
            return float(r[0] ** 2 + r[1] ** 2)
        if _quad():
            return SH.fidelity_density_quad(
                sh, _replicated(pureState), qureg.num_qubits_represented)
        return float(SH.fidelity_density(
            sh, _replicated(pureState), qureg.num_qubits_represented))
    if qureg.is_density_matrix:
        return float(C.calc_fidelity_density(
            qureg.amps, pureState.amps,
            num_qubits=qureg.num_qubits_represented, quad=_quad()))
    ip_fn = C.calc_inner_product_quad if _quad() else C.calc_inner_product
    ip = ip_fn(qureg.amps, pureState.amps).cpu()
    return float(ip[0] ** 2 + ip[1] ** 2)


def _replicated(pure: Qureg):
    """A pure state's whole (2, 2^n) amplitudes on every shard: its shards
    all-gathered (a register of 2^n amplitudes beside a density
    register's 4^n), or the replicated tensor of a register smaller than
    the mesh."""
    amps = pure.amps
    if not isinstance(amps, SH.ShardedAmps):
        return amps
    return amps.mesh.all_gather([s.t() for s in amps.shards]).t()


def calcHilbertSchmidtDistance(a: Qureg, b: Qureg) -> float:
    """Hilbert-Schmidt distance between two density matrices
    (QuEST.h:4911)."""
    V.validate_density_matrix(a, "calcHilbertSchmidtDistance")
    V.validate_density_matrix(b, "calcHilbertSchmidtDistance")
    V.validate_matching_qureg_dims(a, b, "calcHilbertSchmidtDistance")
    sh = _sharded_amps(a)
    if sh is not None:
        if _quad():
            return SH.hilbert_schmidt_distance_quad(sh, b.amps)
        return float(SH.hilbert_schmidt_distance(sh, b.amps))
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
    if qureg.is_sharded:
        _mix_kraus_sharded(qureg, ops, targets)
        return
    qureg.amps = D.apply_kraus_map(
        qureg.amps, ops, num_qubits=qureg.num_qubits_represented,
        targets=tuple(targets))


def _mix_kraus_sharded(qureg: Qureg, ops, targets) -> None:
    """An eager Kraus channel on a sharded density register: its
    superoperator on (T, T+n) as a dense gate.  Judged at the physical
    positions of the live permutation, a channel reaching a sharded bit
    routes through the dense-gate dispatcher (relocalization; the
    reference's distributed multiQubitUnitary strategy,
    QuEST_common.c:630-652 + QuEST_cpu_distributed.c:1503-1545); else
    canonical order is restored and each shard applies it
    (quest_tpu/api_ops.py:244-268)."""
    from .api import _default_route, _dispatch_matrix

    nq = qureg.num_qubits_represented
    nloc = 2 * nq - qureg.shard_bits
    sv_targets = tuple(D.kraus_targets(tuple(targets), nq))
    sup = D.superoperator_from_kraus(ops)
    dt = np.float64 if qureg.dtype == torch.float64 else np.float32
    stacked = CX.soa(sup).astype(dt)
    if PAR.explicit_dist_enabled() and any(
            t >= nloc for t in qureg._phys_bits(sv_targets)):
        _dispatch_matrix(qureg, stacked, sv_targets, (), ())
        return
    amps = qureg.amps
    if all(t < nloc for t in sv_targets):
        qureg.amps = SH.apply_matrix_local(amps, stacked, targets=sv_targets)
        return
    n = qureg.num_qubits_in_state_vec
    _default_route(qureg, lambda a: K.apply_matrix(
        a, stacked, num_qubits=n, targets=sv_targets))


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
    if qureg.is_sharded:
        nq = qureg.num_qubits_represented
        qureg.amps = SH.mix_dephasing(
            qureg.amps, prob, pairs=[(targetQubit, targetQubit + nq)])
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
    if qureg.is_sharded:
        nq = qureg.num_qubits_represented
        qureg.amps = SH.mix_dephasing(
            qureg.amps, prob, pairs=[(qubit1, qubit1 + nq),
                                     (qubit2, qubit2 + nq)])
        return
    qureg.amps = D.mix_two_qubit_dephasing(
        qureg.amps, prob, num_qubits=qureg.num_qubits_represented,
        qubit1=qubit1, qubit2=qubit2)


def _pair_channel_sharded(qureg: Qureg, prob: float, target: int,
                          kind: str) -> bool:
    """Depolarise / damping on a sharded register (quest_tpu/api_ops.py:
    283-300): a bra bit on the mesh takes the exchange form
    (composites.mix_pair_channel_sharded), a local one the elementwise
    form in each shard.  False for a register that is not sharded."""
    if not qureg.is_sharded:
        return False
    nq = qureg.num_qubits_represented
    nloc = 2 * nq - qureg.shard_bits
    if target + nq >= nloc:
        if _explicit_sharded(qureg):
            qureg.amps = COMP.mix_pair_channel_sharded(
                qureg.amps, prob, num_qubits=nq, target=target, kind=kind)
        else:
            _default_route(qureg, lambda a: D.apply_pair_channel(
                a, kind, prob, nn=2 * nq, t=target, b=target + nq))
        return True
    qureg.amps = SH.map_shards(qureg.amps, lambda sh, s, lo:
                               D.apply_pair_channel(sh, kind, prob, nn=nloc,
                                                    t=target, b=target + nq))
    return True


def mixDepolarising(qureg: Qureg, targetQubit: int, prob: float) -> None:
    """One-qubit depolarising channel (QuEST.h:3496): captured as a
    ChannelItem under gateFusion, else the elementwise pair form
    (QuEST_cpu.c:125-246)."""
    V.validate_density_matrix(qureg, "mixDepolarising")
    V.validate_target(qureg, targetQubit, "mixDepolarising")
    V.validate_one_qubit_depol_prob(prob, "mixDepolarising")
    if fusion.capture_pair_channel(qureg, "depol", targetQubit, prob):
        return
    if _pair_channel_sharded(qureg, prob, targetQubit, "depol"):
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
    if _pair_channel_sharded(qureg, prob, targetQubit, "damping"):
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
    if qureg.is_sharded:
        nq = qureg.num_qubits_represented
        nloc = 2 * nq - qureg.shard_bits
        if max(qubit1, qubit2) + nq >= nloc and not _explicit_sharded(qureg):
            _default_route(qureg, lambda a: D.mix_two_qubit_depolarising(
                a, prob, num_qubits=nq, qubit1=qubit1, qubit2=qubit2))
            return
        # with both bra bits local it exchanges nothing (and counts nothing)
        qureg.amps = COMP.mix_two_qubit_depol_sharded(
            qureg.amps, prob, num_qubits=nq, qubit1=qubit1, qubit2=qubit2)
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
    if combineQureg.is_sharded:
        combineQureg.amps = SH.map_shards(
            combineQureg.amps, lambda a, s, lo, b: D.mix_density_matrix(
                a, b.to(a.device), prob), otherQureg.amps)
        return
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
    if out.is_sharded:
        # every operand in canonical order before any is replaced
        a1, a2, ao = qureg1.amps, qureg2.amps, out.amps
        out.amps = SH.map_shards(
            ao, lambda o, s, lo, x, y: K.set_weighted_qureg(
                o, x.to(o.device), y.to(o.device), facs), a1, a2)
        return
    out.amps = K.set_weighted_qureg(out.amps, qureg1.amps, qureg2.amps, facs)


def _apply_matrix_raw(qureg: Qureg, m, targets, controls=()) -> None:
    _telemetry.inc("dispatch_total", family="matrix_raw")
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        calc = (COMP.expec_pauli_sum_density_sharded
                if qureg.is_density_matrix
                else COMP.expec_pauli_sum_statevec_sharded)
        return float(calc(sh, np.ones(1),
                          num_qubits=qureg.num_qubits_represented,
                          codes_flat=_full_codes(qureg, targets, codes),
                          num_terms=1, quad=_quad()))
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        if qureg.is_density_matrix:
            return float(COMP.expec_pauli_sum_density_sharded(
                sh, coeffs, num_qubits=n, codes_flat=codes,
                num_terms=num_terms, quad=_quad()))
        codes_seq = np.asarray(codes, np.int32).reshape(num_terms, n)
        if _explicit_sharded(qureg):
            return float(COMP.expec_pauli_sum_scan_sharded(
                sh, codes_seq, coeffs, num_qubits=n, quad=_quad()))
        return float(P.expec_pauli_sum_scan(_whole(qureg), codes_seq,
                                            coeffs, num_qubits=n,
                                            quad=_quad()))
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
    sh = _sharded_amps(qureg)
    if sh is not None:
        if _quad():
            if qureg.is_density_matrix:
                return complex(*SH.expec_diagonal_density_quad(
                    sh, op.real, op.imag, qureg.num_qubits_represented))
            return complex(*SH.expec_diagonal_statevec_quad(sh, op.real,
                                                            op.imag))
        if qureg.is_density_matrix:
            r = SH.expec_diagonal_density(sh, op.real, op.imag,
                                          qureg.num_qubits_represented)
        else:
            r = SH.expec_diagonal_statevec(sh, op.real, op.imag)
        r = r.cpu()
        return complex(float(r[0]), float(r[1]))
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
    sh = _sharded_amps(inQureg)
    if sh is not None:
        outQureg.amps = COMP.apply_pauli_sum_sharded(
            sh, coeffs, num_qubits=n, codes_flat=codes, num_terms=num_terms)
        return
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
    codes_seq = np.asarray(hamil.pauli_codes)[t_idx].astype(np.int32)
    angles = 2.0 * facs * np.asarray(hamil.term_coeffs, np.float64)[t_idx]
    scan = P.trotter_scan
    if _explicit_sharded(qureg):
        # per term one composed exchange at most (two on a density
        # register): parallel/composites.py
        scan = COMP.trotter_scan_sharded
    elif qureg.is_sharded:
        _default_route(qureg, lambda a: P.trotter_scan(
            a, codes_seq, angles, num_qubits=qureg.num_qubits_in_state_vec,
            rep_qubits=qureg.num_qubits_represented))
        return
    qureg.amps = scan(
        qureg.amps, codes_seq, angles,
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
    if qureg.is_sharded:
        _apply_diagonal_op_sharded(qureg, op)
    elif qureg.is_density_matrix:
        qureg.amps = D.apply_diagonal_op_density(
            qureg.amps, op.real, op.imag,
            num_qubits=qureg.num_qubits_represented)
    else:
        qureg.amps = K.apply_full_diagonal(qureg.amps, op.real, op.imag)
    qureg.qasm_log.comment("here a diagonal operator was applied")


def _apply_diagonal_op_sharded(qureg: Qureg, op: DiagonalOp) -> None:
    """D psi shard by shard (each with its slice of D); D rho through
    composites.apply_diag_op_density_sharded when D splits over the shards
    and its rows are shard-local (quest_tpu/api_ops.py:852-862), else
    with the whole D on every shard."""
    amps = qureg.amps
    if not qureg.is_density_matrix:
        qureg.amps = SH.apply_full_diagonal(amps, op.real, op.imag)
        return
    nq = qureg.num_qubits_represented
    ndev = amps.mesh.axis_size
    if _explicit_sharded(qureg) and (1 << nq) >= ndev \
            and qureg.shard_bits <= nq:
        m = (1 << nq) // ndev
        parts = [(op.real[s * m:(s + 1) * m], op.imag[s * m:(s + 1) * m])
                 for s in amps.mesh.local]
        qureg.amps = COMP.apply_diag_op_density_sharded(
            amps, [p[0] for p in parts], [p[1] for p in parts],
            num_qubits=nq)
        return
    qureg.amps = SH.apply_diag_op_density(amps, op.real, op.imag, nq)


def _phase_map(qureg: Qureg, fn) -> None:
    """Apply the elementwise phase ``fn(amps, offset)`` to the canonical
    state: shard by shard with each shard's first global index on a
    sharded register."""
    amps = qureg.amps
    if isinstance(amps, SH.ShardedAmps):
        qureg.amps = SH.map_shards(amps, lambda sh, s, lo: fn(sh, lo))
    else:
        qureg.amps = fn(amps, 0)


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
    _phase_map(qureg, lambda a, off: PF.apply_phase_func(
        a, np.asarray(coeffs, np.float64),
        np.asarray(exponents, np.float64), inds, phases,
        num_qubits=_sv_n(qureg), qubits=tuple(qubits),
        encoding=int(encoding), offset=off))
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
    _phase_map(qureg, lambda a, off: PF.apply_multi_var_phase_func(
        a, np.asarray(coeffs, np.float64), exps, inds, phases,
        num_qubits=_sv_n(qureg), reg_qubits=regs, encoding=int(encoding),
        terms_per_reg=tuple(int(t) for t in numTermsPerReg), offset=off))
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
    _phase_map(qureg, lambda a, off: PF.apply_named_phase_func(
        a, _pad_params(params, len(regs)), inds, phases,
        num_qubits=_sv_n(qureg), reg_qubits=regs, encoding=int(encoding),
        func_name=int(functionNameCode), offset=off))
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
        _phase_map(qureg, lambda a, off: PF.apply_named_phase_func(
            a, params, inds, phases, num_qubits=_sv_n(qureg),
            reg_qubits=regs, encoding=PF.UNSIGNED,
            func_name=PF.SCALED_PRODUCT, conj=False, offset=off))
        if qureg.is_density_matrix:
            sh = _shift(qureg)
            sregs = tuple(tuple(x + sh for x in reg) for reg in regs)
            _phase_map(qureg, lambda a, off: PF.apply_named_phase_func(
                a, params, inds, phases, num_qubits=_sv_n(qureg),
                reg_qubits=sregs, encoding=PF.UNSIGNED,
                func_name=PF.SCALED_PRODUCT, conj=True, offset=off))
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
    if qureg.is_sharded:
        # quest_tpu/api_ops.py:1105-1126: the whole state vector when at
        # least as many bits are local as shard bits, else the runs
        r = qureg.shard_bits
        if (not qureg.is_density_matrix and start == 0 and nt == nsv
                and nsv - r >= r):
            qureg.amps = COMP.fused_qft_sharded(qureg.amps, num_qubits=nsv)
        elif PAR.explicit_dist_enabled():
            runs = [(start, nt, False)]
            if qureg.is_density_matrix:
                runs.append((start + _shift(qureg), nt, True))
            qureg.amps = COMP.fused_qft_runs_sharded(
                qureg.amps, num_qubits=nsv, runs=tuple(runs))
        else:
            _default_route(qureg, lambda a: CIRC.fused_qft(
                a, nsv, start, nt, shifts=shifts))
        _qft_qasm_trail(qureg, qubits, nt)
        return True
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
