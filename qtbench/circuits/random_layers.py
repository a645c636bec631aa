"""Layers of random one-qubit unitaries and CNOT ladders (the repo's
configuration 2, "depth-20 random circuit of unitary/controlledNot").

Layer d applies a Haar-random 2x2 unitary to every qubit, then
controlledNot(q, q + 1) for q = d % 2, d % 2 + 2, ... < n - 1: 770 calls at
26 qubits and depth 20.  The unitaries are drawn from the seed on the host
(the API takes host matrices), in float64 so that they are unitary to the
API's tolerance.
"""

from __future__ import annotations

import numpy as np


def haar_unitaries(seed, count: int) -> np.ndarray:
    """``count`` Haar-random 2x2 unitaries (complex128) drawn from
    ``seed`` (an integer, or a sequence of them for NumPy's seeding)."""
    rng = np.random.default_rng(seed)
    z = (rng.standard_normal((count, 2, 2))
         + 1j * rng.standard_normal((count, 2, 2))) / np.sqrt(2.0)
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None, :]


def _layers(cfg: dict, us: np.ndarray):
    n, depth = cfg["num_qubits"], cfg["depth"]
    calls = []
    for d in range(depth):
        for q in range(n):
            calls.append(("unitary", (q, us[d * n + q])))
        for q in range(d % 2, n - 1, 2):
            calls.append(("controlledNot", (q, q + 1)))
    return calls


def register_calls(cfg: dict, seed) -> list:
    """The circuit's calls on one register (``seed`` an integer, or a
    sequence of them such as (seed, circuit))."""
    n, depth = cfg["num_qubits"], cfg["depth"]
    return _layers(cfg, haar_unitaries(seed, n * depth))


def bank_calls(cfg: dict, seed, batch: int):
    """(the bank's calls, each element's calls): element b draws its
    unitaries from (seed, b) (from (*seed, b) where ``seed`` is a
    sequence), so that runs with neighbouring seeds share no element; the
    bank applies each layer's unitaries through one applyBatchedUnitary
    per qubit and shares the CNOTs."""
    n, depth = cfg["num_qubits"], cfg["depth"]
    head = list(seed) if isinstance(seed, (list, tuple)) else [seed]
    per = [haar_unitaries(head + [b], n * depth) for b in range(batch)]
    stacked = np.stack(per, axis=1)          # (n * depth, B, 2, 2)
    bank = []
    for name, args in _layers(cfg, np.arange(n * depth)):
        if name == "unitary":
            bank.append(("applyBatchedUnitary",
                         ((args[0],), stacked[args[1]])))
        else:
            bank.append((name, args))
    return bank, [_layers(cfg, us) for us in per]
