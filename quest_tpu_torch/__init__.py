"""quest_tpu_torch: the PyTorch / CUDA port of quest_tpu.

The same camelCase QuEST API, the same SoA ``(2, 2^n)`` amplitude layout
in the same little-endian index order and the same circuit plans as the
JAX package, running on an NVIDIA card.  The fused window passes that
carry a circuit's dense work, and the Pauli-term rotations and
expectation values of Hamiltonian simulation, run in hand-written CUDA
kernels (``csrc/window.cu``, ``csrc/paulis.cu``, built with nvcc at first
use).

Quick start::

    import quest_tpu_torch as qt

    env = qt.createQuESTEnv()            # the CUDA card; raises without one
    q = qt.createQureg(20, env)
    with qt.gateFusion(q):
        qt.hadamard(q, 0)
        for t in range(1, 20):
            qt.controlledNot(q, t - 1, t)
    print(qt.calcProbOfOutcome(q, 19, 1))   # 0.5

``createQuESTEnv(device="cpu")`` runs everything on the CPU, with the
kernels' plain PyTorch versions.
"""

from .precision import set_precision, get_precision, real_eps
from .validation import QuESTError
from .qureg import PauliHamil, Qureg
from .env import QuESTEnv
from .qasm import QASMLogger
from .api import *  # noqa: F401,F403
from .api_ops import *  # noqa: F401,F403
from .fusion import (
    gate_fusion as gateFusion,
    start_gate_fusion as startGateFusion,
    stop_gate_fusion as stopGateFusion,
)

__version__ = "0.1.0"
