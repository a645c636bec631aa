"""quest_tpu_torch tutorial: a basic 3-qubit circuit.

The port's counterpart of examples/tutorial_example.py, walking the same
ground as the reference tutorial (tutorial_example.c): environment setup,
a small circuit mixing named gates, compact/controlled unitaries and a
Toffoli as an N-qubit matrix, then state interrogation and measurement.

Run:  python examples/torch/tutorial_example.py       (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/tutorial_example.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def main():
    # -- environment (once per program) --
    env = qt.createQuESTEnv(device=DEVICE)
    print("-" * 55)
    print("Running the quest_tpu tutorial:")
    print("\tBasic circuit involving a system of 3 qubits.")
    print("-" * 55)

    qubits = qt.createQureg(3, env)
    qt.initZeroState(qubits)

    print("\nThis is our environment:")
    qt.reportQuregParams(qubits)
    qt.reportQuESTEnv(env)

    # -- apply circuit --
    qt.hadamard(qubits, 0)
    qt.controlledNot(qubits, 0, 1)
    qt.rotateY(qubits, 2, 0.1)
    qt.multiControlledPhaseFlip(qubits, [0, 1, 2])

    u = np.array([[0.5 + 0.5j, 0.5 - 0.5j],
                  [0.5 - 0.5j, 0.5 + 0.5j]])
    qt.unitary(qubits, 0, u)

    a, b = 0.5 + 0.5j, 0.5 - 0.5j
    qt.compactUnitary(qubits, 1, a, b)

    qt.rotateAroundAxis(qubits, 2, 3.14 / 2, (1.0, 0.0, 0.0))
    qt.controlledCompactUnitary(qubits, 0, 1, a, b)
    qt.multiControlledUnitary(qubits, [0, 1], 2, u)

    # Toffoli as an explicit 3-qubit matrix
    toff = np.eye(8, dtype=complex)
    toff[6, 6] = toff[7, 7] = 0.0
    toff[6, 7] = toff[7, 6] = 1.0
    qt.multiQubitUnitary(qubits, [0, 1, 2], toff)

    # -- study the output state --
    print("\nCircuit output:")
    print(f"Probability amplitude of |111>: {qt.getProbAmp(qubits, 7):g}")
    print(
        "Probability of qubit 2 being in state 1: "
        f"{qt.calcProbOfOutcome(qubits, 2, 1):g}"
    )

    outcome = qt.measure(qubits, 0)
    print(f"Qubit 0 was measured in state {outcome}")
    outcome, prob = qt.measureWithStats(qubits, 2)
    print(f"Qubit 2 collapsed to {outcome} with probability {prob:g}")

    qt.destroyQureg(qubits, env)
    qt.destroyQuESTEnv(env)


if __name__ == "__main__":
    main()
