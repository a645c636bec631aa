"""Batched registers: banks of same-structure circuits in one program.

The port of the JAX package's ``batch.py``.  Running N variants of one
circuit (a VQE or QAOA parameter sweep, randomized compiling, shot
batches, quantum trajectories) as N registers costs N drains of N plans;
at 16-20 qubits one register fills a handful of the card's 132 SMs per
window pass, so a loop of scalar launches leaves the card idle.

:class:`BatchedQureg` holds a ``(B, 2, 2^n)`` SoA amplitude bank (batch
outer, amplitudes inner).  Gates issued through the ordinary API are
always captured into its fusion buffer, and a drain runs the whole bank
through one program (``fusion._run``): the plan is shared when every
element runs the same matrices (batch flag 1) and planned per element and
stacked when a gate carries a per-element ``(B, 2, s, s)`` matrix (flag 2,
``applyBatchedUnitary``).  Every window pass, megawin group and channel
sweep of the program is ONE kernel launch for the whole bank (K1, K2 and
K5's bank forms, ``ops/fused.py``).  Measurement draws from a per-element
key bank, so batched outcomes are those of B independent seeded runs.

On top of the bank:

- :class:`EnsembleScheduler`: ``submit()`` circuits, ``drain()`` runs them
  grouped by structural fingerprint in power-of-two buckets padded with
  the last submission;
- :func:`run_trajectories`: the quantum-trajectory (Monte-Carlo
  wavefunction) unravelling of mixDephasing / mixDepolarising /
  mixDamping as stochastic gate insertion over a trajectory bank, with the
  observable's mean and standard error.

On an env of R shards a bank of at least R amplitudes per element is
sharded as a register is, the batch axis outermost: each shard holds
``(B, 2, 2^nloc)``, every element's slice of the same global index range
(quest_tpu/batch.py:166-175).  Its drain plans one program for the whole
bank (fusion._run_sharded), each remap moving every element's slice in
one exchange, and K1, K2 and K5 launch in their bank forms on every
shard; measurement sums every element's probability over the mesh at
once, and the expectation values run the sharded scan element by
element.

The banks record the JAX package's telemetry series:
``dispatch_total{family=unitary}`` weighted by the bank size,
``measurement_shots_total``, ``batch_occupancy`` and the ``ensemble_*``
and ``trajectory_*`` series, under the spans ``batch.ensemble_drain`` and
``batch.trajectories``.  A bank checkpoints with its key bank
(``saveQureg``, ``run_resumable``).  The memory governor admits a bank
at its whole footprint, B registers' bytes (``governor.admit_new``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import circuit as C
from . import fusion as _fusion
from . import governor as _gov
from . import telemetry as _telemetry
from .env import QuESTEnv
from .ops import calculations as CALC
from .ops import cplx as CX
from .ops import measurement as M
from .ops import paulis as OPS_P
from .ops import threefry
from .qureg import Qureg
from .validation import QuESTError

__all__ = [
    "BatchedQureg",
    "EnsembleScheduler",
    "bank_gate_items",
    "bank_occupancy",
    "createBatchedQureg",
    "applyBatchedUnitary",
    "measureBatched",
    "calcExpecPauliSumBatched",
    "run_trajectories",
]


# ---------------------------------------------------------------------------
# The register bank
# ---------------------------------------------------------------------------


class BatchedQureg(Qureg):
    """B same-width registers as ONE (B, 2, 2^n) amplitude bank.

    A :class:`Qureg` whose ``amps`` are the bank; its fusion buffer is
    always capturing (it re-arms after a ``stop_gate_fusion``), so API
    gates never fall through to eager scalar dispatch, and the operations
    that would raise the reference's structured error instead."""

    def __init__(self, num_qubits: int, env: QuESTEnv, batch_size: int, *,
                 is_density_matrix: bool = False, seeds=None):
        if int(batch_size) < 1:
            raise QuESTError(
                f"BatchedQureg: batch_size must be >= 1, got {batch_size}")
        self.batch_size = int(batch_size)
        super().__init__(num_qubits, env, is_density_matrix)
        self.seed_elements(seeds)

    @property
    def _fusion(self):
        buf = self.__dict__.get("_fusion_buf")
        if buf is None:
            buf = _fusion.FusionBuffer()
            self.__dict__["_fusion_buf"] = buf
        return buf

    @_fusion.setter
    def _fusion(self, value):
        self.__dict__["_fusion_buf"] = value

    # -- per-element measurement keys ------------------------------------

    def seed_elements(self, seeds=None) -> None:
        """(Re)seed the per-element measurement keys: ``seeds[i]`` seeds
        element i as ``seedQuEST(seeds[i])`` seeds a lone register's
        device measurement stream (ops/measurement._KeyState.seed).
        Default: the global seeds with the element index appended."""
        B = self.batch_size
        if seeds is None:
            from .rng import GLOBAL_RNG

            base = [int(s) for s in (getattr(GLOBAL_RNG, "_keys", None)
                                     or [0])]
            seeds = [base + [i] for i in range(B)]
        if len(seeds) != B:
            raise QuESTError(
                f"BatchedQureg: got {len(seeds)} seeds for a batch of {B}")
        keys = []
        for s in seeds:
            if isinstance(s, (int, np.integer)):
                s = [int(s)]
            keys.append(threefry.key_from_seeds([int(x) for x in s]))
        self._mkeys = np.asarray(keys, dtype=np.uint32)   # (B, 2)
        self._mshots = [0] * B                            # per element

    def key_state(self) -> dict:
        """The per-element (key, shot counter) bank as JSON-serialisable
        lists (the batched analogue of ``KEYS.get_state``)."""
        return {
            "keys": [[int(x) for x in row] for row in self._mkeys],
            "counters": [int(c) for c in self._mshots],
        }

    def set_key_state(self, state: dict) -> None:
        keys = state.get("keys")
        if keys is None or len(keys) != self.batch_size:
            raise QuESTError(
                "BatchedQureg: checkpoint key bank holds "
                f"{0 if keys is None else len(keys)} elements but the "
                f"register batch is {self.batch_size}")
        self._mkeys = np.array(keys, dtype=np.uint32)
        self._mshots = [int(c) for c in state.get(
            "counters", [0] * self.batch_size)]

    # -- bank-aware amplitudes ------------------------------------------

    def _as_bank(self, value):
        """A (2, 2^n) write (the init family writes one state for all
        elements) broadcast to the bank; a (B, 2, 2^n) write binds element
        by element.  On a mesh the bank is written shard by shard: a
        register's ShardedAmps is lifted to every element, and a whole
        state or bank is cut into the shards."""
        if value is None:
            return None
        if self.is_sharded:
            return self._as_sharded_bank(value)
        value = torch.as_tensor(value, dtype=self.dtype, device=self.device)
        if value.dim() == 2:
            return value.unsqueeze(0).expand(
                (self.batch_size,) + tuple(value.shape)).contiguous()
        if value.dim() != 3 or value.shape[0] != self.batch_size:
            raise QuESTError(
                "BatchedQureg: expected amplitudes of shape (2, "
                f"{self.num_amps_total}) or ({self.batch_size}, 2, "
                f"{self.num_amps_total}), got {tuple(value.shape)}")
        return value.contiguous()

    def _as_sharded_bank(self, value):
        from .parallel import sharded as SH

        B = self.batch_size
        if not isinstance(value, SH.ShardedAmps):
            if not torch.is_tensor(value):
                value = torch.from_numpy(np.array(value))
            if tuple(value.shape[-2:]) != (2, self.num_amps_total) \
                    or value.dim() not in (2, 3) \
                    or (value.dim() == 3 and value.shape[0] != B):
                raise QuESTError(
                    "BatchedQureg: expected amplitudes of shape (2, "
                    f"{self.num_amps_total}) or ({B}, 2, "
                    f"{self.num_amps_total}), got {tuple(value.shape)}")
            value = SH.split(self.env.mesh, value, self.num_qubits_in_state_vec
                             - self.shard_bits, self.dtype)
        if not value.batch_size:
            return SH.broadcast_bank(value, B)
        if value.batch_size != B:
            raise QuESTError(
                f"BatchedQureg: sharded amplitudes of {value.batch_size} "
                f"elements for a batch of {B}")
        return value

    @property
    def amps(self):
        return Qureg.amps.fget(self)

    @amps.setter
    def amps(self, value):
        Qureg.amps.fset(self, self._as_bank(value))

    def element(self, i: int):
        """Element ``i``'s amplitudes in canonical order (pending gates
        drain first): a (2, 2^n) tensor, or on a mesh a ShardedAmps of
        the element's shards (the reference's ``amps[b]`` stays sharded
        likewise)."""
        if not 0 <= int(i) < self.batch_size:
            raise QuESTError(
                f"BatchedQureg.element: index {i} out of range for batch "
                f"{self.batch_size}")
        amps = self.amps
        if self.is_sharded:
            return amps.element(int(i))
        return amps[int(i)]


def createBatchedQureg(numQubits: int, env: QuESTEnv, batchSize: int, *,
                       is_density_matrix: bool = False,
                       seeds=None) -> BatchedQureg:
    """Create a bank of ``batchSize`` registers in the zero state
    (|0...0> per element; |0...0><0...0| for a density bank).  ``seeds``
    gives each element its own measurement stream seed (default: the
    global seeds with the element index appended)."""
    from . import validation as V
    from .ops import kernels as K

    V.validate_num_qubits(numQubits, "createBatchedQureg",
                          num_ranks=env.num_ranks)
    q = BatchedQureg(numQubits, env, batchSize,
                     is_density_matrix=is_density_matrix, seeds=seeds)
    _gov.admit_new(q, "createBatchedQureg")
    if q.is_sharded:
        from .parallel import sharded as SH

        # |0...0> and |0><0| are both global index 0
        q.amps = SH.classical(env.mesh, q.num_qubits_in_state_vec
                              - q.shard_bits, q.dtype, 0)
    elif is_density_matrix:
        q.amps = K.init_classical_density(numQubits, 0, q.dtype, q.device)
    else:
        q.amps = K.init_zero_state(q.num_amps_total, q.dtype, q.device)
    return q


# ---------------------------------------------------------------------------
# Per-element gates
# ---------------------------------------------------------------------------


def _soa_per_element(mats, batch: int):
    """Per-element matrices as a (B, 2, s, s) SoA array, from (B, s, s)
    complex or (B, 2, s, s) SoA input."""
    m = np.asarray(mats)
    if m.ndim == 3:
        m = np.stack([CX.soa(m[b]) for b in range(m.shape[0])])
    if m.ndim != 4 or m.shape[0] != batch or m.shape[1] != 2 \
            or m.shape[2] != m.shape[3]:
        raise QuESTError(
            "applyBatchedUnitary: expected matrices of shape (B, s, s) "
            f"complex or (B, 2, s, s) SoA with B={batch}, got "
            f"{tuple(np.asarray(mats).shape)}")
    return m


def _check_capturable(qureg, bits, what: str) -> None:
    if not _fusion._capturable(qureg, bits) or (
            qureg.is_density_matrix and not _fusion._capturable(
                qureg, tuple(b + qureg.num_qubits_represented
                             for b in bits))):
        raise QuESTError(
            f"{what}: the gate does not qualify for the fused path "
            f"(<= {_fusion.FUSION_MAX_GATE_QUBITS} qubits, and shard-local "
            "space for a distributed bank) — batched registers have no "
            "eager fallback")


def applyBatchedUnitary(qureg: BatchedQureg, targets, mats,
                        controls=(), control_states=()) -> None:
    """Apply a different unitary to each element: ``mats[b]`` acts on
    element b's ``targets`` (a density bank gets the conjugated bra twin).
    The stack enters the fusion buffer as one (B, 2, s, s) gate, so the
    bank still drains as one program."""
    if not getattr(qureg, "batch_size", 0):
        raise QuESTError(
            "applyBatchedUnitary: the register is not a BatchedQureg")
    targets = tuple(int(t) for t in targets)
    controls = tuple(int(c) for c in controls)
    B = qureg.batch_size
    stacked = _soa_per_element(mats, B)
    from . import api as _api

    _telemetry.inc_key(_api._K_UNITARY, B)
    if controls:
        stacked = np.stack([
            C.controlled_dense(stacked[b], len(controls), control_states)
            for b in range(B)])
    bits = targets + controls
    _check_capturable(qureg, bits, "applyBatchedUnitary")
    buf = qureg._fusion
    buf.add(C.Gate(bits, stacked))
    if qureg.is_density_matrix:
        sh = qureg.num_qubits_represented
        cstacked = np.stack([stacked[:, 0], -stacked[:, 1]], axis=1)
        buf.add(C.Gate(tuple(b + sh for b in bits), cstacked))


# ---------------------------------------------------------------------------
# Batched measurement and expectation values
# ---------------------------------------------------------------------------


def measureBatched(qureg: BatchedQureg, measureQubit: int):
    """Measure ``measureQubit`` on every element, each drawing from its
    OWN key and shot stream: element b's outcome and probability are
    those of a lone register seeded as element b, measured by
    ``measureWithStats`` (the same arithmetic, element by element).
    Collapses the bank; returns ((B,) int outcomes, (B,) probabilities)
    as NumPy arrays, after one device-to-host copy."""
    from . import validation as V
    from .api_ops import _quad

    if not getattr(qureg, "batch_size", 0):
        raise QuESTError("measureBatched: the register is not a "
                         "BatchedQureg")
    V.validate_target(qureg, measureQubit, "measureBatched")
    _telemetry.inc("measurement_shots_total", qureg.batch_size)
    bank = qureg.amps
    quad = _quad()
    if qureg.is_sharded:
        outs, probs = _measure_sharded_bank(qureg, bank, int(measureQubit),
                                            quad)
        qureg._mshots = [s + 1 for s in qureg._mshots]
        qureg.qasm_log.measure(int(measureQubit))
        o, p = M.to_host(outs, probs)
        return np.asarray(o, dtype=np.int64), np.asarray(p)
    new, outs, probs = [], [], []
    for b in range(qureg.batch_size):
        u = M.thresholds(tuple(int(k) for k in qureg._mkeys[b]),
                         qureg._mshots[b], 1, bank.dtype, bank.device)[0]
        a, o, p = M._measure_once(bank[b], u,
                                  qureg.num_qubits_represented,
                                  int(measureQubit),
                                  qureg.is_density_matrix, quad)
        new.append(a)
        outs.append(o)
        probs.append(p)
    qureg.amps = torch.stack(new)
    qureg._mshots = [s + 1 for s in qureg._mshots]
    qureg.qasm_log.measure(int(measureQubit))
    o, p = M.to_host(torch.stack(outs), torch.stack(probs))
    return np.asarray(o, dtype=np.int64), np.asarray(p)


def _measure_sharded_bank(qureg, bank, target: int, quad: bool):
    """measureBatched on a mesh: every element's threshold from its own
    key, every element's P(target = 0) in one sum over the mesh (at quad,
    element by element in double-double), the outcomes drawn on the
    device, and every element's collapse in one pass over each shard.
    Rebinds the bank; returns the (B,) outcomes and probabilities as
    device tensors."""
    from .parallel import sharded as SH

    nq = qureg.num_qubits_represented
    density = qureg.is_density_matrix
    dev = bank.device
    us = torch.stack([M.thresholds(tuple(int(k) for k in qureg._mkeys[b]),
                                   qureg._mshots[b], 1, bank.dtype, dev)[0]
                      for b in range(qureg.batch_size)])
    if quad:
        p0 = torch.tensor([SH.prob_of_outcome_quad(bank.element(b), target,
                                                   0, density, nq)
                           for b in range(qureg.batch_size)],
                          dtype=bank.dtype, device=dev)
    else:
        p0 = SH.prob_of_outcome_bank(bank, target, 0, is_density=density,
                                     num_qubits=nq)
    outs, probs = M._draw_outcome(p0, us.to(p0.device))
    qureg.amps = SH.collapse_drawn_bank(bank, outs, probs, num_qubits=nq,
                                        target=target, is_density=density)
    return outs, probs


def calcExpecPauliSumBatched(qureg: BatchedQureg, codes, coeffs,
                             *, quad: Optional[bool] = None) -> np.ndarray:
    """Per-element <psi_b| sum_t c_t P_t |psi_b> as a (B,) array: each
    element through the scalar route (``expec_pauli_sum_scan``: one K4
    launch per term on the card, none under quad; on a mesh the sharded
    scan, composites.expec_pauli_sum_scan_sharded), so each value equals
    a lone register's."""
    from .api_ops import _quad as _qd

    if not getattr(qureg, "batch_size", 0):
        raise QuESTError("calcExpecPauliSumBatched: the register is not "
                         "a BatchedQureg")
    quad = _qd() if quad is None else bool(quad)
    codes = np.asarray(codes, np.int32)
    coeffs = np.asarray(coeffs, np.float64)
    n = qureg.num_qubits_represented
    bank = qureg.amps
    if qureg.is_sharded:
        from .parallel import composites as COMP

        vals = [COMP.expec_pauli_sum_scan_sharded(
            bank.element(b), codes, coeffs, num_qubits=n, quad=quad)
            for b in range(qureg.batch_size)]
    else:
        vals = [OPS_P.expec_pauli_sum_scan(bank[b], codes, coeffs,
                                           num_qubits=n, quad=quad)
                for b in range(qureg.batch_size)]
    return torch.stack([v.to(torch.float64).cpu() for v in vals]).numpy()


# ---------------------------------------------------------------------------
# Ensemble scheduler
# ---------------------------------------------------------------------------


def _bucket_size(count: int, max_batch: int) -> int:
    """Next power of two >= count, capped at max_batch."""
    b = 1
    while b < count:
        b <<= 1
    return min(b, max_batch)


def bank_occupancy(qureg, real: Optional[int] = None) -> dict:
    """Bucket occupancy of a batched register: the live batch size, the
    power-of-two bucket it pads to, and the real/padded fraction.  With
    ``real``, the bank was already padded and only ``real`` of its
    elements carry live jobs."""
    bsz = int(getattr(qureg, "batch_size", 0) or 0)
    if not bsz:
        return {"size": 0, "bucket": 0, "occupancy": 1.0}
    if real is not None:
        return {"size": int(real), "bucket": bsz,
                "occupancy": int(real) / bsz}
    bucket = _bucket_size(bsz, 1 << 30)
    return {"size": bsz, "bucket": bucket, "occupancy": bsz / bucket}


def _structure_fingerprint(gates: Sequence, num_qubits: int,
                           is_density: bool) -> tuple:
    """Hashable circuit structure (targets and matrix sizes, not values)
    and the circuit-optimizer mode: submissions with equal fingerprints
    may share a bucket."""
    from . import optimizer as _optimizer

    parts = [("q", int(num_qubits), bool(is_density), _optimizer.mode())]
    for g in gates:
        m = np.asarray(g.mat)
        parts.append((tuple(g.targets), m.shape[-1]))
    return tuple(parts)


def bank_gate_items(streams: Sequence[Sequence], num_qubits: int,
                    is_density: bool, *, qureg=None) -> List:
    """Fuse B same-structure gate streams into ONE bank item list: gate j
    is one shared (2, s, s) item when every element's matrix is bitwise
    identical, else a per-element (B, 2, s, s) item; a density bank gets
    the conjugated bra twin after each.  With ``qureg``, each gate is
    checked against the fused path's capture limits."""
    B = len(streams)
    items: List = []
    for j in range(len(streams[0])):
        mats = [np.asarray(s[j].mat) for s in streams]
        targets = tuple(int(t) for t in streams[0][j].targets)
        if qureg is not None:
            _check_capturable(qureg, targets, "bank_gate_items")
        if all(m.tobytes() == mats[0].tobytes() for m in mats[1:]):
            shared = mats[0]
            items.append(C.Gate(targets, shared))
            if is_density:
                items.append(C.Gate(
                    tuple(t + num_qubits for t in targets),
                    np.stack([shared[0], -shared[1]])))
        else:
            stacked = _soa_per_element(np.stack(mats), B)
            items.append(C.Gate(targets, stacked))
            if is_density:
                items.append(C.Gate(
                    tuple(t + num_qubits for t in targets),
                    np.stack([stacked[:, 0], -stacked[:, 1]], axis=1)))
    return items


class EnsembleScheduler:
    """Collect same-width circuit submissions and run them batched.

    ``submit(gates)`` queues a circuit (a sequence of
    :class:`quest_tpu_torch.circuit.Gate` with NumPy SoA matrices);
    ``drain()`` groups the queue by structural fingerprint, pads each
    group to power-of-two buckets (<= ``max_batch``) with copies of its
    last submission, runs every bucket as ONE BatchedQureg program, and
    returns each submission's final (2, 2^n) amplitudes in submission
    order (on a mesh env, each a ShardedAmps).  ``last_drain`` holds the drain's circuits, buckets, real and
    padded counts and wall seconds."""

    def __init__(self, num_qubits: int, env: QuESTEnv, *,
                 is_density_matrix: bool = False, max_batch: int = 64):
        if max_batch < 1 or (max_batch & (max_batch - 1)):
            raise QuESTError(
                f"EnsembleScheduler: max_batch must be a power of two, "
                f"got {max_batch}")
        self.num_qubits = int(num_qubits)
        self.env = env
        self.is_density_matrix = bool(is_density_matrix)
        self.max_batch = int(max_batch)
        self._pending: List[Tuple[int, tuple, list, object]] = []
        self._next_id = 0
        self.last_drain: dict = {}

    def submit(self, gates: Sequence, *, seed=None) -> int:
        """Queue one circuit; returns its submission id (the index of its
        result in ``drain()``'s list)."""
        gates = list(gates)
        for g in gates:
            if not isinstance(g.mat, np.ndarray):
                raise QuESTError(
                    "EnsembleScheduler.submit: gate matrices must be "
                    "concrete numpy arrays")
        fp = _structure_fingerprint(gates, self.num_qubits,
                                    self.is_density_matrix)
        sid = self._next_id
        self._next_id += 1
        self._pending.append((sid, fp, gates, seed))
        return sid

    def _run_bucket(self, group: list) -> Tuple[dict, int, int]:
        """Run one bucket; returns ({sid: amps}, real, padded)."""
        real = len(group)
        B = _bucket_size(real, self.max_batch)
        padded = group + [group[-1]] * (B - real)
        seeds = [s if s is not None else i
                 for i, (_, _, _, s) in enumerate(padded)]
        q = createBatchedQureg(
            self.num_qubits, self.env, B,
            is_density_matrix=self.is_density_matrix, seeds=seeds)
        items = bank_gate_items([sub[2] for sub in padded],
                                self.num_qubits, self.is_density_matrix,
                                qureg=q)
        from . import api as _api

        _telemetry.inc_key(_api._K_UNITARY, B * len(group[0][2]))
        q._fusion.add(*items)
        out = {sub[0]: q.element(i) for i, sub in enumerate(group)}
        _telemetry.observe("ensemble_bucket_occupancy", real / B)
        return out, real, B

    def drain(self) -> List[torch.Tensor]:
        """Run every pending submission; returns the final amplitudes in
        submission order and clears the queue."""
        if not self._pending:
            return []
        t0 = time.perf_counter()
        pending, self._pending = self._pending, []
        groups: dict = {}
        for sub in pending:
            groups.setdefault(sub[1], []).append(sub)
        results: dict = {}
        occ_real = occ_padded = buckets = 0
        with _telemetry.span("batch.ensemble_drain",
                             circuits=len(pending), groups=len(groups)):
            for group in groups.values():
                for i in range(0, len(group), self.max_batch):
                    res, real, padded = self._run_bucket(
                        group[i:i + self.max_batch])
                    results.update(res)
                    occ_real += real
                    occ_padded += padded
                    buckets += 1
        dt = time.perf_counter() - t0
        if occ_padded:
            _telemetry.set_gauge("batch_occupancy", occ_real / occ_padded)
        _telemetry.inc("ensemble_circuits_total", len(pending))
        if dt > 0:
            _telemetry.set_gauge("ensemble_circuits_per_sec",
                                 len(pending) / dt)
        self.last_drain = {"circuits": len(pending), "groups": len(groups),
                           "buckets": buckets, "real": occ_real,
                           "padded": occ_padded, "seconds": dt}
        return [results[sub[0]] for sub in pending]


# ---------------------------------------------------------------------------
# Quantum trajectories (Monte-Carlo wavefunction unravelling)
# ---------------------------------------------------------------------------

_I2 = np.stack([np.eye(2), np.zeros((2, 2))])
_X2 = np.stack([np.array([[0., 1.], [1., 0.]]), np.zeros((2, 2))])
_Y2 = np.stack([np.zeros((2, 2)), np.array([[0., -1.], [1., 0.]])])
_Z2 = np.stack([np.diag([1., -1.]), np.zeros((2, 2))])


def _sample_pauli_insertion(kind: str, prob: float, u: np.ndarray):
    """Per-trajectory Pauli of a unitary-proportional channel: dephasing
    Z with probability p; depolarising X, Y or Z with p/3 each (the
    channels' state-independent Kraus weights)."""
    B = u.shape[0]
    mats = np.broadcast_to(_I2, (B, 2, 2, 2)).copy()
    if kind == "dephasing":
        mats[u < prob] = _Z2
    else:
        third = prob / 3.0
        mats[u < third] = _X2
        mats[(u >= third) & (u < 2 * third)] = _Y2
        mats[(u >= 2 * third) & (u < prob)] = _Z2
    return mats


def _sample_damping(qureg: BatchedQureg, target: int, prob: float,
                    rng: np.random.Generator):
    """Amplitude damping is state-dependent: the jump probability is
    p <1|rho_b|1>, so the bank drains, each element's excited population
    is read (one copy), and the renormalised Kraus branch of each element
    (jump: sqrt(p)|0><1| / sqrt(p p1); no jump: diag(1, sqrt(1-p)) /
    sqrt(1 - p p1)) applies as one per-element gate."""
    B = qureg.batch_size
    bank = qureg.amps
    if qureg.is_sharded:
        from .parallel import sharded as SH

        p1 = SH.prob_of_outcome_bank(bank, int(target), 1)
    else:
        p1 = torch.stack([CALC.calc_prob_of_outcome_statevec(
            bank[b], num_qubits=qureg.num_qubits_represented,
            target=int(target), outcome=1) for b in range(B)])
    p1 = p1.to(torch.float64).cpu().numpy()
    pjump = np.clip(prob * p1, 0.0, 1.0)
    u = rng.random(B)
    jump = u < pjump
    mats = np.zeros((B, 2, 2, 2))
    for b in range(B):
        if jump[b]:
            mats[b, 0, 0, 1] = np.sqrt(prob) / np.sqrt(pjump[b])
        else:
            keep = max(1.0 - pjump[b], np.finfo(np.float64).tiny)
            mats[b, 0, 0, 0] = 1.0 / np.sqrt(keep)
            mats[b, 0, 1, 1] = np.sqrt(1.0 - prob) / np.sqrt(keep)
    return mats


_NOISE_KINDS = ("dephasing", "depolarising", "damping")


def run_trajectories(ops: Sequence, num_qubits: int, env: QuESTEnv,
                     n_traj: int, *, observable=None, seed: int = 0):
    """Unravel a noisy circuit as ``n_traj`` quantum trajectories run as
    ONE batched state-vector program.

    ``ops`` is a sequence of circuit entries in order: a
    :class:`quest_tpu_torch.circuit.Gate` (applied to every trajectory), or
    ``(kind, target, prob)`` with kind in ``("dephasing", "depolarising",
    "damping")``, the stochastic unravelling of the matching mix* density
    channel: each trajectory samples its own Kraus branch (host RNG,
    seeded by ``seed``) and the B choices apply as one per-element gate.

    Returns a dict: ``values``, the (n_traj,) per-trajectory expectation
    of ``observable`` (a (codes, coeffs) Pauli-sum pair); ``mean`` and
    ``sem``, its sample mean and standard error, which converge to the
    density-matrix expectation as 1/sqrt(B).  With ``observable=None``,
    the final (n_traj, 2, 2^n) bank instead (key ``amps``)."""
    if n_traj < 1:
        raise QuESTError(f"run_trajectories: n_traj must be >= 1, got "
                         f"{n_traj}")
    from . import api as _api

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    q = createBatchedQureg(num_qubits, env, n_traj,
                           seeds=[seed + i for i in range(n_traj)])
    nsites = 0
    with _telemetry.span("batch.trajectories", n_traj=n_traj,
                         ops=len(ops)):
        for op in ops:
            if isinstance(op, C.Gate):
                _telemetry.inc_key(_api._K_UNITARY, n_traj)
                q._fusion.add(op)
                continue
            kind, target, prob = op
            if kind not in _NOISE_KINDS:
                raise QuESTError(
                    f"run_trajectories: unknown noise kind {kind!r} "
                    f"(expected one of {_NOISE_KINDS})")
            nsites += 1
            prob = float(prob)
            if kind == "damping":
                mats = _sample_damping(q, int(target), prob, rng)
            else:
                mats = _sample_pauli_insertion(kind, prob,
                                               rng.random(n_traj))
            applyBatchedUnitary(q, (int(target),), mats)
        _telemetry.inc("trajectory_runs_total", n_traj)
        _telemetry.set_gauge("trajectory_noise_sites", nsites)
        if observable is None:
            out = {"amps": q.amps}
        else:
            codes, coeffs = observable
            vals = calcExpecPauliSumBatched(q, codes, coeffs)
            sem = float(vals.std(ddof=1) / np.sqrt(n_traj)) \
                if n_traj > 1 else float("nan")
            out = {"values": vals, "mean": float(vals.mean()), "sem": sem}
    dt = time.perf_counter() - t0
    if dt > 0:
        _telemetry.set_gauge("trajectories_per_sec", n_traj / dt)
    return out
