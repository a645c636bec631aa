"""Bernstein-Vazirani with quest_tpu_torch.

The port's counterpart of examples/bernstein_vazirani.py: finds a secret
bit-string with a single oracle query, as the reference demonstrates
(bernstein_vazirani_circuit.c): ancilla qubit 0 in |->, H on the input
register, CNOTs encoding the secret into the ancilla, H again, then
measure the input register.

Run:  python examples/torch/bernstein_vazirani.py      (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/bernstein_vazirani.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def main():
    num_qubits = 9
    secret = 2 ** 4 + 1

    env = qt.createQuESTEnv(device=DEVICE)
    qureg = qt.createQureg(num_qubits, env)
    qt.initZeroState(qureg)

    # ancilla (qubit 0) to |1>, then everything to the Hadamard basis
    qt.pauliX(qureg, 0)
    for q in range(num_qubits):
        qt.hadamard(qureg, q)

    # oracle: CNOT each secret bit onto the ancilla (secret bit i lives on
    # qubit i+1, matching the reference's layout)
    for q in range(1, num_qubits):
        if (secret >> (q - 1)) & 1:
            qt.controlledNot(qureg, q, 0)

    # back out of the Hadamard basis; input register now encodes the secret
    for q in range(1, num_qubits):
        qt.hadamard(qureg, q)

    found = 0
    for q in range(1, num_qubits):
        found |= qt.measure(qureg, q) << (q - 1)

    print(f"secret = {secret}, recovered = {found}")
    assert found == secret

    qt.destroyQureg(qureg, env)
    qt.destroyQuESTEnv(env)


if __name__ == "__main__":
    main()
