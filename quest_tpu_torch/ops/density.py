"""Density-matrix channels: decoherence as plain PyTorch tensor code.

The counterpart of the JAX package's ``ops/density.py``.  A density matrix
of n qubits is stored as the reference stores it (QuEST.c:8-10): a
flattened 2n-qubit state vector, column-major, ket qubits 0..n-1 (low
index bits) and bra qubits n..2n-1.

Channels are realised through the Choi isomorphism: a Kraus map {K_k} on
targets T becomes the dense superoperator sum_k conj(K_k) (x) K_k, applied
as an ordinary 2k-qubit matrix on targets (T, T+n) (the reference's
generic path, QuEST_common.c:595-652).  Dephasing, depolarising and
damping have elementwise forms (QuEST_cpu.c:48-385): a sign mask, or a
combination of each element with its partner across both target bits.
Fused runs of depolarising and damping channels on the card go through
the K5 sweep kernel (``ops/fused.py``); these are the per-channel forms.

Every function returns a new tensor and leaves its input as it was.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import cplx, gatedefs
from . import kernels as K


def superoperator_from_kraus(kraus_ops):
    """sum_k conj(K_k) (x) K_k, acting on [bra bits | ket bits] of the
    column-major vec(rho) (macro_populateKrausOperator,
    QuEST_common.c:595-628), as a NumPy complex128 matrix."""
    s = None
    for k in kraus_ops:
        k = np.asarray(k, dtype=np.complex128)
        term = np.kron(np.conj(k), k)
        s = term if s is None else s + term
    return s


def kraus_targets(targets: Sequence[int], num_qubits: int) -> Tuple[int, ...]:
    """Superoperator target list: ket targets then bra twins (t+n)."""
    return tuple(targets) + tuple(t + num_qubits for t in targets)


def apply_kraus_map(amps, kraus_ops, *, num_qubits: int,
                    targets: Tuple[int, ...]):
    """mixKrausMap / mixTwoQubitKrausMap / mixMultiQubitKrausMap
    (QuEST_common.c:630-728)."""
    s = superoperator_from_kraus(kraus_ops)
    return K.apply_matrix(amps, cplx.soa(s), num_qubits=2 * num_qubits,
                          targets=kraus_targets(targets, num_qubits))


def _scalar(value, amps):
    """A 0-d tensor of the state's type: the channel's arithmetic rounds
    where the JAX package's (``jnp.asarray(prob, amps.dtype)``) does."""
    return torch.tensor(value, dtype=torch.float64).to(dtype=amps.dtype,
                                                      device=amps.device)


def mix_dephasing(amps, prob, *, num_qubits: int, target: int):
    """rho -> (1-p) rho + p Z rho Z: elements whose ket and bra target
    bits differ are multiplied by (1-2p) (densmatr_mixDephasing,
    QuEST_cpu.c:48-90)."""
    n = num_qubits
    p = _scalar(prob, amps)
    sign = K.parity_sign_2d(2 * n, (target, target + n), amps.dtype,
                            amps.device)
    view = amps.reshape(2, *sign.shape)
    return (view * ((1 - p) + p * sign)[None]).reshape(amps.shape)


def mix_two_qubit_dephasing(amps, prob, *, num_qubits: int, qubit1: int,
                            qubit2: int):
    """rho -> (1-p) rho + p/3 (Z1 rho Z1 + Z2 rho Z2 + Z1Z2 rho Z1Z2)
    (densmatr_mixTwoQubitDephasing, QuEST_cpu.c:92-123)."""
    n = num_qubits
    p = _scalar(prob, amps)
    s1 = K.parity_sign_2d(2 * n, (qubit1, qubit1 + n), amps.dtype,
                          amps.device)
    s2 = K.parity_sign_2d(2 * n, (qubit2, qubit2 + n), amps.dtype,
                          amps.device)
    factor = (1 - p) + (p / 3) * (s1 + s2 + s1 * s2)
    view = amps.reshape(2, *s1.shape)
    return (view * factor[None]).reshape(amps.shape)


def _pair_channel(amps, nn: int, t: int, b: int, w_same0, w_same1, w_diff,
                  w2_00, w2_11):
    """out = w1(kt, bt) * rho + w2(kt, bt) * partner, the partner being
    the element with both target bits flipped.  Weights by block: w1 =
    w_same0 at (0,0), w_same1 at (1,1), w_diff off the diagonal; w2 =
    w2_00 at (0,0), w2_11 at (1,1), 0 off the diagonal.  Small states
    select the weights on the interleaved axis view; states of
    kernels._BIG_N bits and more build them from bit indicators on the
    (2^hi, 2^lo) view, as the JAX package does (the two round the
    diagonal weights differently: w_diff + (w_same - w_diff))."""
    dt = amps.dtype
    if nn < K._BIG_N:
        shape = (2, 1 << (nn - 1 - b), 2, 1 << (b - 1 - t), 2, 1 << t)
        v = amps.reshape(shape)
        part = torch.flip(v, dims=(2, 4))
        zero = torch.zeros((), dtype=dt, device=amps.device)

        def tab(a00, a01, a10, a11):
            return torch.stack([torch.stack([a00, a01]),
                                torch.stack([a10, a11])]).reshape(
                                    1, 1, 2, 1, 2, 1)

        w1 = tab(w_same0, w_diff, w_diff, w_same1)
        w2 = tab(w2_00, zero, zero, w2_11)
        return (v * w1 + part * w2).reshape(amps.shape)
    part = K._flip_bits_flat(amps.reshape(2, -1), nn, (t, b))
    kt = K.bit_2d(nn, t, amps.device).to(dt)
    bt = K.bit_2d(nn, b, amps.device).to(dt)
    same = 1 - (kt - bt) * (kt - bt)     # 1 where kt == bt
    k1b1 = kt * bt
    k0b0 = same - k1b1
    del same
    w1 = w_diff + (w_same0 - w_diff) * k0b0 + (w_same1 - w_diff) * k1b1
    w2 = w2_00 * k0b0 + w2_11 * k1b1
    del k0b0, k1b1
    hi, lo = K._split2(nn)
    v = amps.reshape(2, 1 << hi, 1 << lo)
    # in place on the partner copy, which this function owns: at 2^30
    # amplitudes each temporary is 8.6 GB
    pv = part.reshape(2, 1 << hi, 1 << lo).mul_(w2[None])
    out = v * w1[None]
    return out.add_(pv).reshape(amps.shape)


def apply_pair_channel(amps, kind: str, prob, *, nn: int, t: int, b: int):
    """The depolarise / damping one-pass form with explicit bit positions:
    ``nn`` index bits, ket bit ``t`` and bra bit ``b`` (the fusion drain's
    "chan" parts)."""
    p = _scalar(prob, amps)
    one = torch.ones((), dtype=amps.dtype, device=amps.device)
    if kind == "depol":
        return _pair_channel(amps, nn, t, b,
                             w_same0=1 - 2 * p / 3, w_same1=1 - 2 * p / 3,
                             w_diff=1 - 4 * p / 3,
                             w2_00=2 * p / 3 * one, w2_11=2 * p / 3 * one)
    if kind == "damping":
        return _pair_channel(amps, nn, t, b,
                             w_same0=one, w_same1=1 - p,
                             w_diff=torch.sqrt(1 - p),
                             w2_00=p * one, w2_11=0 * one)
    raise ValueError(f"unknown pair channel {kind!r}")


def mix_depolarising(amps, prob, *, num_qubits: int, target: int):
    """rho -> (1-p) rho + p/3 (X rho X + Y rho Y + Z rho Z) in one
    elementwise pass over the double-flip partner pairing
    (densmatr_mixDepolarisingLocal, QuEST_cpu.c:125-246):

        rho'[ket bit == bra bit]  = (1-2p/3) rho + (2p/3) partner
        rho'[ket bit != bra bit]  = (1-4p/3) rho
    """
    n = num_qubits
    return apply_pair_channel(amps, "depol", prob, nn=2 * n, t=target,
                              b=target + n)


def mix_damping(amps, prob, *, num_qubits: int, target: int):
    """Amplitude damping in one elementwise pass (densmatr_mixDampingLocal,
    QuEST_cpu.c:300-385): population flows |1><1| -> |0><0| while
    coherences scale by sqrt(1-p)."""
    n = num_qubits
    return apply_pair_channel(amps, "damping", prob, nn=2 * n, t=target,
                              b=target + n)


def mix_two_qubit_depolarising(amps, prob, *, num_qubits: int, qubit1: int,
                               qubit2: int):
    """rho -> (1-p) rho + p/15 sum over the 15 non-identity Pauli pairs
    (densmatr_mixTwoQubitDepolarising, QuEST_cpu.c:387-733) as two
    double-flip partner sums and one elementwise combine:

        rho' = (1 - 16p/15) rho + (4p/15) * block * S,

    S = (1 + F2)(1 + F1) rho, F_i flipping (ket_i, bra_i); block = 1 where
    both ket target bits equal their bra bits."""
    n = num_qubits
    nn = 2 * n
    dt = amps.dtype
    p = _scalar(prob, amps)
    t1, b1 = qubit1, qubit1 + n
    t2, b2 = qubit2, qubit2 + n
    flat = amps.reshape(2, -1)
    s = flat + K._flip_bits_flat(flat, nn, (t1, b1))
    s = s + K._flip_bits_flat(s, nn, (t2, b2))
    hi, lo = K._split2(nn)

    def same(t, b):
        kt = K.bit_2d(nn, t, amps.device).to(dt)
        bt = K.bit_2d(nn, b, amps.device).to(dt)
        return 1 - (kt - bt) * (kt - bt)

    block = same(t1, b1) * same(t2, b2)
    c1 = 1 - 16 * p / 15
    c2 = 4 * p / 15
    v = flat.reshape(2, 1 << hi, 1 << lo)
    sv = s.reshape(2, 1 << hi, 1 << lo)
    return (v * c1 + sv * (c2 * block)[None]).reshape(amps.shape)


def depolarising_kraus(prob):
    """{sqrt(1-p) I, sqrt(p/3) X, sqrt(p/3) Y, sqrt(p/3) Z}
    (mixDepolarising, QuEST.h:3496)."""
    p = float(prob)
    return [math.sqrt(1 - p) * gatedefs.PAULI_I,
            math.sqrt(p / 3) * gatedefs.PAULI_X,
            math.sqrt(p / 3) * gatedefs.PAULI_Y,
            math.sqrt(p / 3) * gatedefs.PAULI_Z]


def damping_kraus(prob):
    """K0 = diag(1, sqrt(1-p)), K1 = sqrt(p)|0><1| (mixDamping,
    QuEST.h:3534)."""
    p = float(prob)
    k0 = np.array([[1, 0], [0, math.sqrt(1 - p)]], dtype=np.complex128)
    k1 = np.array([[0, math.sqrt(p)], [0, 0]], dtype=np.complex128)
    return [k0, k1]


def pauli_kraus(prob_x, prob_y, prob_z):
    """mixPauli's four Kraus operators (QuEST_common.c:730-750)."""
    p0 = 1 - float(prob_x) - float(prob_y) - float(prob_z)
    return [math.sqrt(p0) * gatedefs.PAULI_I,
            math.sqrt(float(prob_x)) * gatedefs.PAULI_X,
            math.sqrt(float(prob_y)) * gatedefs.PAULI_Y,
            math.sqrt(float(prob_z)) * gatedefs.PAULI_Z]


def two_qubit_depolarising_kraus(prob):
    """{sqrt(1-p) II} + {sqrt(p/15) P_i (x) P_j : (i,j) != (I,I)}
    (mixTwoQubitDepolarising, QuEST.h:3601)."""
    prob = float(prob)
    ops = []
    for i in range(4):
        for j in range(4):
            p = (1 - prob) if (i == 0 and j == 0) else prob / 15
            # kron(second-qubit Pauli, first-qubit Pauli): targets[0] is
            # the least significant superoperator bit
            ops.append(math.sqrt(p) * np.kron(gatedefs.PAULI_MATRICES[j],
                                              gatedefs.PAULI_MATRICES[i]))
    return ops


def mix_density_matrix(amps, other_amps, prob):
    """rho -> (1-p) rho + p rho_other (densmatr_mixDensityMatrix,
    QuEST_cpu.c:125-160)."""
    p = _scalar(prob, amps)
    return (1 - p) * amps + p * other_amps


def init_pure_state_density(psi_amps, *, num_qubits: int):
    """rho = |psi><psi| flattened column-major: kron(conj(psi), psi)
    (densmatr_initPureStateLocal's outer product, QuEST_cpu.c:1184).  SoA:
    with u = conj(psi), re = kron(u0, p0) - kron(u1, p1), and so on."""
    p0, p1 = psi_amps[0].reshape(-1), psi_amps[1].reshape(-1)
    if p0.numel() != 1 << num_qubits:
        raise ValueError(f"init_pure_state_density: a state of "
                         f"{p0.numel()} amplitudes is not one of "
                         f"{num_qubits} qubits")
    re = torch.kron(p0, p0) + torch.kron(p1, p1)
    im = torch.kron(p0, p1) - torch.kron(p1, p0)
    return torch.stack([re, im])


def apply_diagonal_op_density(amps, op_real, op_imag, *, num_qubits: int):
    """Left-multiply D rho: scale each column elementwise by D over the
    ket bits (densmatr_applyDiagonalOpLocal, QuEST_cpu.c:4042-4082).  The
    apply* family: no conjugate twin."""
    dim = 1 << num_qubits
    mat = amps.reshape(2, dim, dim)  # [channel, col, row]; rows are ket bits
    f_re = op_real.to(amps.dtype)[None, :]
    f_im = op_imag.to(amps.dtype)[None, :]
    return cplx.cmul(mat, f_re, f_im).reshape(amps.shape)
