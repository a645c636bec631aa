"""Hamiltonian time evolution with quest_tpu_torch: Trotterised dynamics
of a transverse-field Ising chain, with energy and magnetisation tracked.

The port's counterpart of examples/trotter_evolution.py.  The reference
exposes the workload through applyTrotterCircuit + calcExpecPauliHamil
(QuEST.h:5455, 4285); on the card each term's rotation is one launch of
the direct Pauli-rotation kernel (K3, ops/paulis.py) and each term's
expectation one launch of K4.

Physics check carried in the output: the evolution conserves <H> (H
commutes with e^{-iHt}) to float precision, while the transverse
magnetisation <sum_q X_q> oscillates, the standard TFIM quench signature.

Run:  python examples/torch/trotter_evolution.py      (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/trotter_evolution.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def tfim_hamiltonian(n, j=1.0, h=0.7):
    """H = -J sum ZZ - h sum X as a PauliHamil (codes, coeffs)."""
    terms = []
    coeffs = []
    for q in range(n - 1):
        row = [0] * n
        row[q] = row[q + 1] = 3          # Z Z
        terms.append(row)
        coeffs.append(-j)
    for q in range(n):
        row = [0] * n
        row[q] = 1                        # X
        terms.append(row)
        coeffs.append(-h)
    return np.asarray(terms), np.asarray(coeffs)


def main():
    n = int(os.environ.get("QT_EVOLVE_QUBITS", "12"))
    steps = int(os.environ.get("QT_EVOLVE_STEPS", "20"))
    dt = 0.05

    env = qt.createQuESTEnv(device=DEVICE)
    codes, coeffs = tfim_hamiltonian(n)
    hamil = qt.createPauliHamil(n, len(coeffs))
    qt.initPauliHamil(hamil, coeffs, codes)

    # X magnetisation observable
    mx_codes = []
    for q in range(n):
        row = [0] * n
        row[q] = 1
        mx_codes.append(row)
    mx = qt.createPauliHamil(n, n)
    qt.initPauliHamil(mx, np.ones(n), np.asarray(mx_codes))

    # quench from the fully polarised |0...0> state
    psi = qt.createQureg(n, env)
    qt.initZeroState(psi)

    e0 = qt.calcExpecPauliHamil(psi, hamil)
    print(f"TFIM chain n={n}, J=1, h=0.7, dt={dt}, order-2 Trotter")
    print(f"t=0.00  <H>={e0:+.6f}  <Mx>="
          f"{qt.calcExpecPauliHamil(psi, mx):+.6f}")

    drift_max = 0.0
    for s in range(1, steps + 1):
        qt.applyTrotterCircuit(psi, hamil, dt, 2, 1)
        if s % max(1, steps // 5) == 0:
            e = qt.calcExpecPauliHamil(psi, hamil)
            m = qt.calcExpecPauliHamil(psi, mx)
            drift_max = max(drift_max, abs(e - e0))
            print(f"t={s * dt:.2f}  <H>={e:+.6f}  <Mx>={m:+.6f}")

    tot = qt.calcTotalProb(psi)
    print(f"energy drift |<H>(t) - <H>(0)| <= {drift_max:.2e} "
          f"(conserved up to Trotter error O(dt^2) + float precision)")
    print(f"totalProb = {tot:.8f}")
    assert drift_max < 2e-3 * abs(e0), (drift_max, e0)
    assert abs(tot - 1.0) < 1e-4, tot
    print("OK")


if __name__ == "__main__":
    main()
