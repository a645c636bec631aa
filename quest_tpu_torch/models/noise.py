"""The benchmark noise layer: bench.py config 4 (BASELINE.json config 4).

A density register under a noise layer: one ``mixDepolarising`` per qubit,
then one ``mixTwoQubitKrausMap`` on qubits (0, 1) with four random 4 x 4
Kraus operators, read out by ``calcFidelity`` against |+>^n.  The Kraus
operators are drawn on the host exactly as bench.py draws them
(``np.random.default_rng(seed)``, normalised by the inverse Cholesky
factor of sum K^dag K), so both packages apply the same map.
"""

from __future__ import annotations

import numpy as np


def bench_kraus_ops(seed: int = 5):
    """Config 4's four two-qubit Kraus operators (bench.py:266-272)."""
    rng = np.random.default_rng(seed)
    raw = rng.standard_normal((4, 4, 4)) + 1j * rng.standard_normal((4, 4, 4))
    s = np.zeros((4, 4), dtype=complex)
    for k in raw:
        s += k.conj().T @ k
    w = np.linalg.inv(np.linalg.cholesky(s).conj().T)
    return [k @ w for k in raw]


def noise_layer(qt, rho, n: int, kops, prob: float = 0.05) -> None:
    """One config-4 noise layer on the n-qubit density register ``rho``
    through the API module ``qt`` (bench.py:275-279)."""
    for q in range(n):
        qt.mixDepolarising(rho, q, prob)
    qt.mixTwoQubitKrausMap(rho, 0, 1, kops)
