"""Shot sampling with quest_tpu_torch: the fused measurement path.

The port's counterpart of examples/shot_sampling.py.  The reference's
measurement loop (measure() per qubit) is one host round trip per qubit:
a full-state probability reduction, a host Mersenne-Twister draw, then a
collapse sweep (QuEST_common.c:374-380).  ``measureSequence`` reads a
whole register in one call, its thresholds drawn on the host once and
the reductions and collapses on the device.

The demo prepares a GHZ-like state plus local rotations, takes repeated
full-register shots (re-preparing between shots, as a sampling workload
does), and prints the bitstring histogram.  Seeded via seedQuEST, so runs
are reproducible, and draw the JAX package's stream.

Run:  python examples/torch/shot_sampling.py      (the CUDA card)
      QT_EXAMPLES_CPU=1 python examples/torch/shot_sampling.py
"""

import os
import sys
from collections import Counter

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import quest_tpu_torch as qt

# the CPU only when asked for; otherwise the card, or an error without one
DEVICE = "cpu" if os.environ.get("QT_EXAMPLES_CPU") == "1" else None


def prepare(env, n):
    q = qt.createQureg(n, env)
    with qt.gateFusion(q):          # the prep drains as few fused passes
        qt.hadamard(q, 0)
        for t in range(1, n):
            qt.controlledNot(q, t - 1, t)
        for t in range(n):
            qt.rotateY(q, t, 0.15 * (t + 1))
    return q


def main():
    n = int(os.environ.get("QT_SHOT_QUBITS", "10"))
    shots = int(os.environ.get("QT_SHOT_COUNT", "200"))
    env = qt.createQuESTEnv(device=DEVICE)
    qt.seedQuEST(env, [1234])

    counts = Counter()
    for _ in range(shots):
        q = prepare(env, n)
        outcomes, _probs = qt.measureSequence(q, range(n))
        counts["".join(map(str, reversed(outcomes)))] += 1
        qt.destroyQureg(q, env)

    print(f"{shots} shots on {n} qubits -> {len(counts)} distinct bitstrings")
    for bits, c in counts.most_common(5):
        print(f"  |{bits}> : {c}")
    # GHZ correlations survive the local rotations: samples cluster
    # around |0..0> and |1..1> (few bit flips from either pole)
    def flips(bits):
        return min(bits.count("1"), bits.count("0"))
    near_pole = sum(c for b, c in counts.items() if flips(b) <= 2)
    top2 = sum(c for _, c in counts.most_common(2))
    print(f"top-2 mass: {top2 / shots:.2f}; "
          f"within 2 flips of a pole: {near_pole / shots:.2f}")


if __name__ == "__main__":
    main()
