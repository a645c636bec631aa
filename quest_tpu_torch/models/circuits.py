"""The benchmark circuits: bench.py config 2 (BASELINE.json config 2) and
config 3's read-out.

A depth-d random circuit on n qubits: per layer one Haar-random 1q unitary
on every qubit, then a CNOT ladder on alternating pairs, followed by a
probability read-out.  The unitaries are drawn on the host exactly as the
JAX package draws them (``np.random.default_rng(seed)``, one QR per gate)
and cast to float32 as it does, so both packages run the same circuit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import circuit as C
from ..ops import cplx

# float64, unlike the JAX package's float32 CNOT_SOA: the planner rewrites
# a CNOT into pre/post factors and a diagonal mask in the gate matrix's own
# dtype (circuit.controlled_form_2q), and float32 factors are off unitary
# by ~1e-7, which loses ~1e-7 of the norm per CNOT (2.3e-5 of the norm at
# 16 qubits, depth 20).  The 0/1 matrix itself is the same in both dtypes.
CNOT_SOA = np.zeros((2, 4, 4))
CNOT_SOA[0] = np.array(
    [[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]])


def _random_unitary_host(rng):
    a = rng.standard_normal((2, 2)) + 1j * rng.standard_normal((2, 2))
    q, r = np.linalg.qr(a)
    return q * (np.diag(r) / np.abs(np.diag(r)))


def bench_unitaries(num_qubits: int, depth: int, seed: int = 0,
                    dtype=np.float32) -> np.ndarray:
    """(depth, n, 2, 2, 2) SoA unitaries: the same draw as the JAX
    package's build_random_circuit, cast to float32 as it casts them
    (``dtype=np.float64`` keeps the draw exactly unitary in f64, which
    the API's unitarity check at double precision requires)."""
    rng = np.random.default_rng(seed)
    us = np.empty((depth, num_qubits, 2, 2, 2))
    for d in range(depth):
        for q in range(num_qubits):
            us[d, q] = cplx.soa(_random_unitary_host(rng))
    return us.astype(dtype)


def bench_gate_list(num_qubits: int, depth: int, unitaries):
    """The config-2 gate list (per-layer 1q unitaries + alternating CNOT
    ladder) as circuit.Gate objects.  CNOT convention: control = matrix
    bit 0 (= targets[0]), target = bit 1."""
    gates = []
    for d in range(depth):
        for q in range(num_qubits):
            gates.append(C.Gate((q,), np.asarray(unitaries[d, q])))
        for q in range(d % 2, num_qubits - 1, 2):
            gates.append(C.Gate((q, q + 1), CNOT_SOA))
    return gates


def zero_state_canonical(num_qubits: int, dtype=torch.float32,
                         device="cuda"):
    """|0...0> in the canonical (2, nb, 128, 128) view."""
    nb = 1 << (num_qubits - 14)
    a = torch.zeros((2, nb, 128, 128), dtype=dtype, device=device)
    a[0, 0, 0, 0] = 1.0
    return a


def prob_top_zero_canonical(a):
    """P(top qubit = 0) on the canonical view: the sum of |amp|^2 over the
    first half of the rows.  Needs n >= 15."""
    if a.shape[1] < 2:
        raise ValueError("prob_top_zero_canonical needs >= 2 rows (n >= 15)")
    h = a[:, : a.shape[1] // 2]
    return torch.sum(h * h)


def amp00_canonical(a):
    """Re amp_0 of a state in the canonical view, as a 0-d tensor: bench.py
    config 3's check (an even number of QFTs maps |0...0> back to itself,
    so amp_0 is 1)."""
    return torch.sum(a[:1, :1, :1, :1])
