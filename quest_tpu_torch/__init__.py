"""quest_tpu_torch: the PyTorch / CUDA port of quest_tpu.

The same camelCase QuEST API, the same SoA ``(2, 2^n)`` amplitude layout
in the same little-endian index order and the same circuit plans as the
JAX package, running on an NVIDIA card.  The fused window passes that
carry a circuit's dense work, the Pauli-term rotations and expectation
values of Hamiltonian simulation, the QFT's ladder layers and the fused
decoherence-channel sweeps of a density matrix run in hand-written CUDA
kernels (``csrc/*.cu``, built with nvcc at first use).  Measurement draws
the JAX package's seeded outcome streams: its threefry keys by default,
its host Mersenne Twister under ``QT_HOST_MEASURE=1``.  A
``BatchedQureg`` bank of B registers drains through one program whose
window passes, megawin groups and channel sweeps are one launch each for
the whole bank (``batch.py``); ``set_precision(4)`` takes the reductions
in double-double; ``models.vqe`` and ``models.qaoa`` train through
``torch.autograd``.

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
kernels' plain PyTorch versions.  ``createQuESTEnv(devices=[...])`` splits
registers over several shards (``devices=["cuda:0"] * 8``: eight shards
on one card; ``["cpu"] * 8`` on the CPU), and after ``initDistributed``
an env holds one shard per torch.distributed rank (``parallel``, ``PAR``:
the exchange layer, parallel/dist.py).

``runResumable(q, gates, dir, every=...)`` drives a long circuit window
by window, committing a checkpoint generation after each window and
resuming bit for bit after a kill; ``saveQureg`` / ``loadQureg`` snapshot
a register; ``telemetry`` holds the counters, gauges, histograms and
spans every layer records (``QT_TELEMETRY=off|on|trace``), and
``reportPerf(env)`` prints them.  The memory ``governor`` admits
registers and drains against a budget per device (the card's free memory,
or ``QT_HBM_BUDGET_BYTES``) and spills idle registers to pinned host
memory; ``explainCircuit(q)`` reports what a drain would plan, exchange
and hold without running it; ``audit`` counts a function's exchange calls
against a ``CollectiveBudget``.
"""

from .precision import (
    set_precision,
    get_precision,
    real_eps,
    real_dtype,
    complex_dtype,
    validation_eps,
    MAX_NUM_REGS_APPLY_ARBITRARY_PHASE,
)
from .validation import QuESTError
from .qureg import DiagonalOp, PauliHamil, Qureg
from .env import QuESTEnv
from .qasm import QASMLogger
from .api import *  # noqa: F401,F403
from .api_ops import *  # noqa: F401,F403
from .fusion import (
    gate_fusion as gateFusion,
    start_gate_fusion as startGateFusion,
    stop_gate_fusion as stopGateFusion,
)
from .rng import GLOBAL_RNG
from .checkpoint import (
    saveQureg,
    loadQureg,
    writeStateToFile,
    readStateFromFile,
)
from .resilience import (
    run_resumable as runResumable,
    run_resumable,
    check_qureg_health as checkQuregHealth,
    FaultPlan,
    SimulatedPreemption,
    NumericalHealthError,
    WindowExecutor,
    degradation_report,
)
from .debug import (
    initStateOfSingleQubit,
    initStateFromSingleFile,
    compareStates,
)
from .optimizer import set_circuit_optimizer, get_circuit_optimizer
from .batch import (
    BatchedQureg,
    EnsembleScheduler,
    createBatchedQureg,
    applyBatchedUnitary,
    measureBatched,
    calcExpecPauliSumBatched,
    run_trajectories,
    run_trajectories as runTrajectories,
)
from . import models
from . import parallel
from . import telemetry
from . import utils
from .telemetry import report_perf as reportPerf, report_perf
from . import contracts
from . import governor
from .governor import MemoryAdmissionError
from . import introspect
from .introspect import (
    explain_circuit,
    explain_circuit as explainCircuit,
    report_circuit_plan,
    report_circuit_plan as reportCircuitPlan,
    audit,
    CollectiveBudget,
)
from .parallel import dist as PAR
from .ops import phasefunc as _pf

# enum phaseFunc (QuEST.h:231-234)
NORM = _pf.NORM
SCALED_NORM = _pf.SCALED_NORM
INVERSE_NORM = _pf.INVERSE_NORM
SCALED_INVERSE_NORM = _pf.SCALED_INVERSE_NORM
SCALED_INVERSE_SHIFTED_NORM = _pf.SCALED_INVERSE_SHIFTED_NORM
PRODUCT = _pf.PRODUCT
SCALED_PRODUCT = _pf.SCALED_PRODUCT
INVERSE_PRODUCT = _pf.INVERSE_PRODUCT
SCALED_INVERSE_PRODUCT = _pf.SCALED_INVERSE_PRODUCT
DISTANCE = _pf.DISTANCE
SCALED_DISTANCE = _pf.SCALED_DISTANCE
INVERSE_DISTANCE = _pf.INVERSE_DISTANCE
SCALED_INVERSE_DISTANCE = _pf.SCALED_INVERSE_DISTANCE
SCALED_INVERSE_SHIFTED_DISTANCE = _pf.SCALED_INVERSE_SHIFTED_DISTANCE

# bitEncoding (QuEST.h:269)
UNSIGNED = _pf.UNSIGNED
TWOS_COMPLEMENT = _pf.TWOS_COMPLEMENT

__version__ = "0.1.0"
