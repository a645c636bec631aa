"""Quantum Phase Estimation with quest_tpu_torch.

The port's counterpart of examples/phase_estimation.py.  Estimates the
eigenphase phi of U = diag(1, e^{2 pi i phi}) acting on a one-qubit
eigenstate |1>, using an m-qubit counting register:

    1. Hadamard every counting qubit,
    2. controlled-U^(2^k) from counting qubit k (controlledPhaseShift:
       U is diagonal, so the controlled power is a phase shift),
    3. INVERSE QFT on the counting register,
    4. measure: the counting register collapses near round(phi * 2^m).

The inverse QFT is built from the public API (swaps + reversed
H/controlled-phase ladder: the adjoint of agnostic_applyQFT,
QuEST_common.c:836-898), and with --fused the whole circuit runs inside
gateFusion, so that it drains as a handful of fused passes.

Run:  python examples/torch/phase_estimation.py [--fused]   (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/phase_estimation.py [--fused]
"""

import math
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def inverse_qft(qureg, qubits):
    """Adjoint of the textbook QFT on ``qubits`` (ascending significance):
    undo the final swap network, then each layer's controlled-phase ladder
    (negated angles) and Hadamard in reverse order."""
    n = len(qubits)
    for i in range(n // 2):
        qt.swapGate(qureg, qubits[i], qubits[n - 1 - i])
    for j in range(n):
        for k in range(j):
            qt.controlledPhaseShift(
                qureg, qubits[k], qubits[j], -math.pi / (1 << (j - k)))
        qt.hadamard(qureg, qubits[j])


def run(num_counting, phi, fused=False):
    env = qt.createQuESTEnv(device=DEVICE)
    n = num_counting + 1
    eigen = num_counting                      # the eigenstate qubit
    q = qt.createQureg(n, env)
    qt.initClassicalState(q, 1 << eigen)      # |1> on the eigenstate qubit

    def circuit():
        for k in range(num_counting):
            qt.hadamard(q, k)
        for k in range(num_counting):
            # controlled-U^(2^k): U diagonal -> one phase shift
            qt.controlledPhaseShift(
                q, k, eigen, 2 * math.pi * phi * (1 << k))
        inverse_qft(q, list(range(num_counting)))

    if fused:
        with qt.gateFusion(q):
            circuit()
    else:
        circuit()

    outcome = 0
    for k in range(num_counting):
        outcome |= qt.measure(q, k) << k
    qt.destroyQureg(q, env)
    qt.destroyQuESTEnv(env)
    return outcome / (1 << num_counting)


def main():
    num_counting = int(os.environ.get("QPE_QUBITS", "8"))
    phi = float(os.environ.get("QPE_PHI", "0.3828125"))  # 98/256: exact at m=8
    fused = "--fused" in sys.argv
    est = run(num_counting, phi, fused=fused)
    print(f"phi = {phi}")
    print(f"estimate ({num_counting} counting qubits"
          f"{', fused' if fused else ''}) = {est}")
    print(f"|error| = {abs(est - phi)} (<= {1 / (1 << num_counting)} "
          f"guaranteed for exactly-representable phases)")


if __name__ == "__main__":
    main()
