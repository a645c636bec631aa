"""Gate-matrix builders.

The reference decomposes rotations into (alpha, beta) Givens pairs fed to
compactUnitary (QuEST_common.c:120-139, 306-372); here every 1/2-qubit gate
is just its dense matrix, built host-side with NumPy (4..16 complex
numbers).  A copy of the JAX package's gate table, so both packages build
bit-identical matrices.

Conventions match the reference exactly: rotateX/Y/Z = exp(-i theta/2 P).
"""

from __future__ import annotations

import numpy as np

PAULI_I = np.eye(2, dtype=np.complex128)
PAULI_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
PAULI_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
PAULI_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)
HADAMARD = np.array([[1, 1], [1, -1]], dtype=np.complex128) / np.sqrt(2)
S_GATE_DIAG = np.array([1, 1j], dtype=np.complex128)
T_GATE_DIAG = np.array([1, np.exp(1j * np.pi / 4)], dtype=np.complex128)
Z_DIAG = np.array([1, -1], dtype=np.complex128)

PAULI_MATRICES = (PAULI_I, PAULI_X, PAULI_Y, PAULI_Z)

# Basis rotations taking Z to X / Y (multiRotatePauli decomposition,
# QuEST_common.c:424-462)
RY_M90 = (1 / np.sqrt(2)) * np.array([[1, 1], [-1, 1]], dtype=np.complex128)
RX_P90 = (1 / np.sqrt(2)) * np.array([[1, -1j], [-1j, 1]], dtype=np.complex128)

# (reference sqrtSwap matrix, QuEST_common.c:397-421)
SQRT_SWAP = np.array(
    [
        [1, 0, 0, 0],
        [0, 0.5 + 0.5j, 0.5 - 0.5j, 0],
        [0, 0.5 - 0.5j, 0.5 + 0.5j, 0],
        [0, 0, 0, 1],
    ],
    dtype=np.complex128,
)


def compact_unitary_matrix(alpha, beta) -> np.ndarray:
    """[[alpha, -conj(beta)], [beta, conj(alpha)]] (QuEST.h compactUnitary)."""
    a, b = complex(alpha), complex(beta)
    return np.array([[a, -np.conj(b)], [b, np.conj(a)]])


def rotate_x_matrix(theta) -> np.ndarray:
    t = float(theta) / 2
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -1j * s], [-1j * s, c]])


def rotate_y_matrix(theta) -> np.ndarray:
    t = float(theta) / 2
    c, s = np.cos(t), np.sin(t)
    return np.array([[c, -s], [s, c]], dtype=np.complex128)


def rotate_z_diag(theta) -> np.ndarray:
    t = float(theta) / 2
    return np.array([np.exp(-1j * t), np.exp(1j * t)])


def phase_shift_diag(theta) -> np.ndarray:
    """diag(1, e^{i theta}) (reference phaseShift, QuEST.h:1595)."""
    return np.array([1.0, np.exp(1j * float(theta))])


def rotate_around_axis_matrix(theta, axis_xyz) -> np.ndarray:
    """exp(-i theta/2 n.sigma), n normalised (reference
    getComplexPairFromRotation, QuEST_common.c:120-139)."""
    ax = np.asarray(axis_xyz, dtype=np.float64)
    ax = ax / np.linalg.norm(ax)
    t = float(theta) / 2
    c, s = np.cos(t), np.sin(t)
    nx, ny, nz = ax
    return np.array(
        [
            [c - 1j * s * nz, -s * ny - 1j * s * nx],
            [s * ny - 1j * s * nx, c + 1j * s * nz],
        ]
    )


def pauli_product_matrix(codes) -> np.ndarray:
    """Dense matrix of a Pauli string; codes[0] acts on the least-significant
    (first-target) qubit, matching apply_matrix's target convention."""
    m = None
    for code in codes:
        p = PAULI_MATRICES[int(code)]
        m = p if m is None else np.kron(p, m)
    return m
