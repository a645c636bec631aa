"""Grover's search with quest_tpu_torch.

The port's counterpart of examples/grovers_search.py: amplitude
amplification of a randomly chosen marked element via oracle + diffuser
built from pauliX / multiControlledPhaseFlip / hadamard API calls, as the
reference demonstrates (grovers_search.c).

Two execution styles:
  --api    gate-at-a-time imperative API (reference style; default)
  --fused  the whole search as one function of raw amplitude tensors
           (quest_tpu_torch.models.circuits.grover_circuit), read out
           through ops.calculations.

Run:  python examples/torch/grovers_search.py [--fused]    (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/grovers_search.py [--fused]
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def apply_oracle(qureg, num_qubits, sol):
    """Flip the sign of |sol>: X-conjugate a controlled-Z on all qubits."""
    for q in range(num_qubits):
        if not (sol >> q) & 1:
            qt.pauliX(qureg, q)
    qt.multiControlledPhaseFlip(qureg, list(range(num_qubits)))
    for q in range(num_qubits):
        if not (sol >> q) & 1:
            qt.pauliX(qureg, q)


def apply_diffuser(qureg, num_qubits):
    """2|+><+| - I via H / X conjugation of the all-qubit phase flip."""
    for q in range(num_qubits):
        qt.hadamard(qureg, q)
    for q in range(num_qubits):
        qt.pauliX(qureg, q)
    qt.multiControlledPhaseFlip(qureg, list(range(num_qubits)))
    for q in range(num_qubits):
        qt.pauliX(qureg, q)
    for q in range(num_qubits):
        qt.hadamard(qureg, q)


def run_api(num_qubits, sol, num_reps):
    env = qt.createQuESTEnv(device=DEVICE)
    qureg = qt.createQureg(num_qubits, env)
    qt.initPlusState(qureg)
    for r in range(num_reps):
        apply_oracle(qureg, num_qubits, sol)
        apply_diffuser(qureg, num_qubits)
        print(f"prob of solution |{sol}> = {qt.getProbAmp(qureg, sol):g}")
    qt.destroyQureg(qureg, env)
    qt.destroyQuESTEnv(env)


def run_fused(num_qubits, sol, num_reps):
    from quest_tpu_torch.models import circuits
    from quest_tpu_torch.ops import calculations

    amps = circuits.grover_circuit(num_qubits, sol, device=DEVICE)
    prob = calculations.calc_prob_of_all_outcomes_statevec(
        amps, num_qubits=num_qubits, qubits=tuple(range(num_qubits))
    )[sol]
    print(f"prob of solution |{sol}> after {num_reps} fused reps = {float(prob):g}")


def main():
    num_qubits = int(os.environ.get("QT_GROVER_QUBITS", "12"))
    num_elems = 2 ** num_qubits
    num_reps = math.ceil(math.pi / 4 * math.sqrt(num_elems))
    print(f"numQubits: {num_qubits}, numElems: {num_elems}, numReps: {num_reps}")

    rng = np.random.default_rng()
    sol = int(rng.integers(num_elems))

    if "--fused" in sys.argv:
        run_fused(num_qubits, sol, num_reps)
    else:
        run_api(num_qubits, sol, num_reps)


if __name__ == "__main__":
    main()
