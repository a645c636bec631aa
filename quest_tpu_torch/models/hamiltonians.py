"""The benchmark Hamiltonian: bench.py config 5 (BASELINE.json config 5).

A random PauliHamil on n qubits: ``terms`` standard-normal coefficients,
then a uniform code in {I, X, Y, Z} for every (term, qubit), drawn on the
host exactly as bench.py draws them (``np.random.default_rng(seed)``), so
both packages evolve and measure the same Hamiltonian.
"""

from __future__ import annotations

import numpy as np


def bench_pauli_hamil(num_qubits: int, terms: int = 16, seed: int = 7):
    """(coeffs (T,) float64, codes (T, n) int64): the arguments of
    initPauliHamil for the config-5 Hamiltonian."""
    rng = np.random.default_rng(seed)
    coeffs = rng.standard_normal(terms)
    codes = rng.integers(0, 4, size=(terms, num_qubits))
    return coeffs, codes
