"""The quantum Fourier transform of the whole register (the repo's
configuration 3, "30-qubit QFT via controlledPhaseShift + swapGate"; the
``qft`` circuit of MQT Bench and QASMBench).

Route ``api`` (the default) is the one call a user makes,
``applyFullQFT``.  Route ``gates`` (a mix that names it) writes the
transform as the source names it: for each qubit j from the top down,
hadamard(j) and controlledPhaseShift(k, j, pi / 2^(j-k)) for every k < j,
then swapGate(i, n - 1 - i) for i < n / 2.
"""

from __future__ import annotations

import math


def register_calls(cfg: dict, seed: int, route: str = "api") -> list:
    n = cfg["num_qubits"]
    if route == "api":
        return [("applyFullQFT", ())]
    if route != "gates":
        raise ValueError(f"the QFT has no route {route!r}")
    calls = []
    for j in range(n - 1, -1, -1):
        calls.append(("hadamard", (j,)))
        for k in range(j - 1, -1, -1):
            calls.append(("controlledPhaseShift",
                          (k, j, math.pi / (1 << (j - k)))))
    for i in range(n // 2):
        calls.append(("swapGate", (i, n - 1 - i)))
    return calls
