"""Whole-circuit functions on raw SoA amplitude tensors, and the benchmark
circuits: bench.py config 2 (BASELINE.json config 2) and config 3's
read-out.

The circuit functions (``ghz_layer``, ``build_random_circuit``, ``qft_circuit``,
``grover_circuit``, ``bernstein_vazirani_circuit``) are the JAX package's
``models/circuits.py`` on torch tensors: the example models and the bench
scripts' circuits, gate by gate through ``ops/kernels.py`` (the QFT
through ``circuit.fused_qft``).  Those that make a state take an explicit
device; None is the card.

Config 2 is a depth-d random circuit on n qubits: per layer one
Haar-random 1q unitary on every qubit, then a CNOT ladder on alternating
pairs, followed by a probability read-out.  The unitaries are drawn on the
host exactly as the JAX package draws them (``np.random.default_rng(seed)``,
one QR per gate) and cast to float32 as it does, so both packages run the
same circuit.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import circuit as C
from ..ops import cplx, gatedefs, kernels, phasefunc

_H_SOA = cplx.soa(gatedefs.HADAMARD)

def _device(device):
    return torch.device("cuda" if device is None else device)


def ghz_layer(amps, num_qubits: int):
    """H on qubit 0, then a CNOT chain up the register."""
    amps = kernels.apply_matrix(amps, _H_SOA, num_qubits=num_qubits,
                                targets=(0,))
    for t in range(1, num_qubits):
        amps = kernels.apply_multi_qubit_not(
            amps, num_qubits=num_qubits, targets=(t,), controls=(t - 1,))
    return amps


def build_random_circuit(num_qubits: int, depth: int, seed: int = 0,
                         use_scan: bool = True, device=None):
    """Returns (fn, unitaries): fn(amps, unitaries) applies the whole
    depth-layer circuit (a Haar-random 1q unitary on every qubit, then the
    CNOT ladder on pairs starting at d % 2).  ``unitaries`` is the JAX
    package's float32 draw (``bench_unitaries``) as a tensor on
    ``device``.  ``use_scan`` is kept for the JAX package's signature:
    there it rolls the depth loop into ``lax.scan``; torch has no such
    construct, so both values run the same unrolled loop."""
    del use_scan
    n = num_qubits
    unitaries = torch.as_tensor(bench_unitaries(n, depth, seed),
                                device=_device(device))

    def fn(amps, unitaries):
        for d in range(depth):
            for q in range(n):
                amps = kernels.apply_matrix(amps, unitaries[d, q],
                                            num_qubits=n, targets=(q,))
            for q in range(d % 2, n - 1, 2):
                amps = kernels.apply_multi_qubit_not(
                    amps, num_qubits=n, targets=(q + 1,), controls=(q,))
        return amps

    return fn, unitaries


def qft_circuit(amps, num_qubits: int, layered: bool = False):
    """The full QFT.  Default (n >= 14): ``circuit.fused_qft``, one ladder
    pass per high layer, the low layers folded by the windowed planner and
    the swap network as one bit reversal; the input is consumed.
    ``layered=True``, or n below 14, takes the reference's per-layer
    strategy: H + SCALED_PRODUCT phase-ladder sweeps + pairwise swaps
    (agnostic_applyQFT, QuEST_common.c:836-898)."""
    n = num_qubits
    if not layered and n >= 14:
        return C.fused_qft(amps, n, 0, n)
    empty_i = np.zeros((0, 2), np.int64)
    empty_p = np.zeros((0,), np.float64)
    for q in range(n - 1, -1, -1):
        amps = kernels.apply_matrix(amps, _H_SOA, num_qubits=n, targets=(q,))
        if q == 0:
            break
        amps = phasefunc.apply_named_phase_func(
            amps, np.array([math.pi / (1 << q), 0.0]), empty_i, empty_p,
            num_qubits=n, reg_qubits=(tuple(range(q)), (q,)),
            encoding=phasefunc.UNSIGNED, func_name=phasefunc.SCALED_PRODUCT)
    for i in range(n // 2):
        amps = kernels.swap_qubit_amps(amps, num_qubits=n, qb1=i,
                                       qb2=n - i - 1)
    return amps


def _flip_one(n: int, index: int) -> np.ndarray:
    """SoA (2, 2^n) diagonal: 1 everywhere but -1 at ``index``."""
    d = np.zeros((2, 1 << n))
    d[0] = 1.0
    d[0, index] = -1.0
    return d


def grover_circuit(num_qubits: int, marked: int, dtype=torch.float32,
                   device=None):
    """Grover search (the reference's examples/grovers_search.c) from its
    own |+>^n start state on ``device``: round(pi/4 sqrt(2^n)) rounds of
    the oracle (flip the marked amplitude) and the diffusion H^n (flip
    |0>) H^n."""
    n = num_qubits
    d_marked, d_zero = _flip_one(n, marked), _flip_one(n, 0)
    amps = kernels.init_plus_state(1 << n, dtype, _device(device))
    targets = tuple(range(n))
    for _ in range(max(1, int(round(math.pi / 4 * math.sqrt(2 ** n))))):
        amps = kernels.apply_diagonal(amps, d_marked, num_qubits=n,
                                      targets=targets)
        for q in range(n):
            amps = kernels.apply_matrix(amps, _H_SOA, num_qubits=n,
                                        targets=(q,))
        amps = kernels.apply_diagonal(amps, d_zero, num_qubits=n,
                                      targets=targets)
        for q in range(n):
            amps = kernels.apply_matrix(amps, _H_SOA, num_qubits=n,
                                        targets=(q,))
    return amps


def bernstein_vazirani_circuit(num_qubits: int, secret: int,
                               dtype=torch.float32, device=None):
    """Bernstein-Vazirani (the reference's
    examples/bernstein_vazirani_circuit.c) as a phase oracle from its own
    |+>^n start state on ``device``: the phase (-1)^(s.x), then H^n, which
    leaves |secret>."""
    n = num_qubits
    signs = np.array([(-1.0) ** bin(i & secret).count("1")
                      for i in range(1 << n)])
    d_oracle = np.stack([signs, np.zeros(1 << n)])
    amps = kernels.init_plus_state(1 << n, dtype, _device(device))
    amps = kernels.apply_diagonal(amps, d_oracle, num_qubits=n,
                                  targets=tuple(range(n)))
    for q in range(n):
        amps = kernels.apply_matrix(amps, _H_SOA, num_qubits=n, targets=(q,))
    return amps


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
