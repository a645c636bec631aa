"""Fault-tolerant execution: resumable circuit runs, fault injection and
a numerical-health watchdog (the port of the JAX package's
``resilience.py``, with the same public names and behaviour).

* **Resumable execution**: :func:`run_resumable` drives a gate stream in
  fusion windows of ``every`` gates and checkpoints at each window
  boundary (never mid-window) with a generation protocol.  A generation
  is written beside the last good one: the amplitudes are copied to the
  host synchronously (through one pinned buffer on the card) and written
  as ``amps.npy`` in one background thread while the metadata is
  written; the generation is committed (a ``COMMITTED`` marker, then an
  atomic rename of the ``LATEST`` pointer) only after the thread is
  joined and the file fsynced, so a crash at any point before the commit
  leaves the previous generation loadable.  The metadata extends
  ``saveQureg``'s with the gate cursor, the RAW logical->physical
  permutation (``Qureg._perm``: restoring canonical order would change
  the later plans and break bit-exact resume) and both measurement
  streams' state (the host MT19937 and the device key and shot
  counter), so a resumed run is bit-identical to an uninterrupted one.
  On torch.distributed ranks the ranks write a generation together: each
  its own shards' rows of one ``amps.npy``, between barriers, and rank 0
  the metadata and the commit.

* **Fault injection**: a deterministic :class:`FaultPlan`
  (``QT_FAULT_PLAN`` or programmatic): kills between windows and
  mid-save, post-commit corruption, transient IO errors (absorbed by
  :func:`retry_io`'s bounded backoff), NaN/Inf in one shard, norm drift,
  exchange stalls and shard or host loss.

* **Watchdog**: :func:`check_qureg_health` is one reduction on the device
  (per shard, the partials summed once) and one readback per window,
  with the policies ``raise``, ``renormalize`` and ``rollback``.

* **Elastic failover**: a shard loss during a guarded exchange dispatch
  rolls back to the last good generation, shrinks the mesh to the
  surviving half (env.shrink_env), reshards the generation onto it and
  resumes.

* **Degradations**: a process-wide registry (:func:`record_degradation`)
  of irreversible downgrades: mesh shrinks, failovers and exchange-chunk
  settings; getEnvironmentString appends the report.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import shutil
import threading
import time
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry as _telemetry
from .validation import QuESTError

# structured run-context logging: every checkpoint/restore/watchdog event
# of run_resumable emits one JSON line through this logger
_RUN_LOG = logging.getLogger("quest_tpu_torch.resilience")


def _log_event(run_id: str, event: str, **fields) -> None:
    payload = {"event": event, "run": run_id}
    payload.update(fields)
    _RUN_LOG.info(json.dumps(payload, sort_keys=True))


# ---------------------------------------------------------------------------
# Degradation registry
# ---------------------------------------------------------------------------

# name -> reason; written once per process by subsystems that fell back
# to a degraded configuration (env.get_environment_string reports it)
DEGRADATIONS: dict = {}


def record_degradation(name: str, reason: str) -> None:
    """Record (and warn about, once) an irreversible in-process downgrade:
    a mesh shrink, a failover, an exchange-chunk setting corrected."""
    if name in DEGRADATIONS:
        return
    DEGRADATIONS[name] = reason
    _telemetry.inc("degradations_total", name=name)
    _telemetry.flight_event("degradation", name=name, reason=reason)
    warnings.warn(f"quest_tpu_torch degraded: {name}: {reason}",
                  stacklevel=2)


def degradation_report() -> dict:
    """Snapshot of every recorded downgrade (name -> reason)."""
    return dict(DEGRADATIONS)


# ---------------------------------------------------------------------------
# Errors
# ---------------------------------------------------------------------------


class SimulatedPreemption(RuntimeError):
    """Raised by an injected ``kill``/``killsave`` fault: stands in for
    the SIGKILL of a preempted job; not a QuESTError, so it cannot be
    taken for a validation failure."""


class NumericalHealthError(QuESTError):
    """The watchdog found a non-finite amplitude or norm drift beyond
    tolerance.  Carries the offending window (its gate range), the
    rollback cursor when the ``rollback`` policy restored state, and on
    a register bank the worst element."""

    def __init__(self, msg: str, *, window: Optional[Tuple[int, int]] = None,
                 norm: Optional[float] = None, finite: bool = True,
                 rolled_back_to: Optional[int] = None,
                 element: Optional[int] = None):
        super().__init__(msg)
        self.window = window
        self.norm = norm
        self.finite = finite
        self.rolled_back_to = rolled_back_to
        self.element = element


# ---------------------------------------------------------------------------
# Bounded exponential-backoff retry for checkpoint IO
# ---------------------------------------------------------------------------

_RETRY_ATTEMPTS_ENV = "QT_RETRY_ATTEMPTS"
_RETRY_BASE_ENV = "QT_RETRY_BASE_SECONDS"

# the FaultPlan driving the current run_resumable (or a test): retry_io
# consults it for injected transient errors
_ACTIVE_FAULTS: List[Optional["FaultPlan"]] = [None]

_CHAOS_SEED_ENV = "QT_CHAOS_SEED"

# the backoff-jitter stream: its own generator, never GLOBAL_RNG (the
# measurement stream), so a retry cannot shift measurement outcomes
_JITTER_RNG: List[Optional[object]] = [None]


def seed_backoff_jitter(seeds: Optional[Sequence[int]] = None) -> None:
    """(Re)seed the backoff-jitter stream: ``seeds``, else
    ``QT_CHAOS_SEED``, else time+pid (jitter exists to desynchronise
    concurrent retriers, so the unseeded default differs per process)."""
    from . import rng as _rng

    r = _rng._MeasurementRNG()
    if seeds is None:
        raw = os.environ.get(_CHAOS_SEED_ENV, "").strip()
        if raw:
            seeds = [int(raw)]
        else:
            # qlint: allow(nondeterminism): unseeded jitter must decorrelate across processes; QT_CHAOS_SEED pins it
            seeds = [int(time.time() * 1e6), os.getpid()]
    r.seed([int(s) for s in seeds])
    _JITTER_RNG[0] = r


def backoff_delay(base: float, prev: Optional[float]) -> float:
    """One decorrelated-jitter backoff delay: uniform on
    [base, min(64*base, 3*prev)], from :func:`seed_backoff_jitter`'s
    stream."""
    if _JITTER_RNG[0] is None:
        seed_backoff_jitter()
    base = max(float(base), 1e-9)
    cap = base * 64.0
    prev = base if (prev is None or prev <= 0.0) else float(prev)
    hi = max(base, min(cap, 3.0 * prev))
    return base + (hi - base) * float(_JITTER_RNG[0].uniform())


def retry_io(fn, *args, attempts: Optional[int] = None,
             base_delay: Optional[float] = None, what: str = "checkpoint IO",
             **kwargs):
    """Call ``fn`` retrying transient IO failures (OSError/TimeoutError)
    with bounded decorrelated-jitter backoff (:func:`backoff_delay`): the
    wrapper around every checkpoint write and read.  A persistent failure
    raises a QuESTError naming the operation and the attempt count, the
    last error chained."""
    if attempts is None:
        attempts = int(os.environ.get(_RETRY_ATTEMPTS_ENV, "4"))
    if base_delay is None:
        base_delay = float(os.environ.get(_RETRY_BASE_ENV, "0.05"))
    last = None
    delay: Optional[float] = None
    for k in range(max(1, attempts)):
        plan = _ACTIVE_FAULTS[0]
        if plan is not None and plan.take_io_fault():
            last = OSError(f"injected transient IO error ({what})")
        else:
            try:
                return fn(*args, **kwargs)
            except (OSError, TimeoutError) as e:
                last = e
        _telemetry.inc("checkpoint_io_retries_total", what=what)
        if k + 1 < attempts:
            delay = backoff_delay(base_delay, delay)
            time.sleep(delay)
    raise QuESTError(
        f"{what}: failed after {attempts} attempts "
        f"(last error: {last!r})") from last


# ---------------------------------------------------------------------------
# Fault injection
# ---------------------------------------------------------------------------


class FaultPlan:
    """A deterministic schedule of injected faults, keyed on the absolute
    window index of a resumable run (window w covers gates
    [w*every, (w+1)*every)).  Build it programmatically
    (``FaultPlan("kill@2,io@3")``) or from ``QT_FAULT_PLAN``
    (:meth:`from_env`).  Kinds:

    - ``kill@W``       raise SimulatedPreemption before window W runs
    - ``killsave@W``   crash mid-save: after window W's generation is
                       written but before its commit
    - ``corrupt@W``    after committing window W's generation, overwrite
                       its payload and metadata with garbage
    - ``io@N``         the next N checkpoint IO operations raise a
                       transient OSError (absorbed by retry_io)
    - ``nan@W``        poke a NaN into the last shard after window W runs
                       (before its watchdog check)
    - ``inf@W``        the same with +Inf
    - ``scale@W``      multiply the amplitudes by 1.01 after window W
                       (norm drift, for the ``renormalize`` policy)
    - ``stall@W``      window W's first exchange dispatch stalls once:
                       absorbed by the guard's retries
                       (dist.guarded_dispatch), counted in
                       exchange_timeouts_total
    - ``shard_loss@W`` a shard dies during window W's exchange dispatch:
                       the guard raises dist.ShardLossError and
                       run_resumable fails over
    - ``host_loss@W``  a whole host's shards die during window W's
                       dispatch: the failover excludes the host's range
    - ``oom@W``        window W's first drain dispatch fails once with
                       an injected allocator failure, before it runs:
                       the memory governor's OOM net (governor.oom_net)
                       evicts idle registers and retries; two events on
                       one window exhaust the retry

    The serving layer (serve.SimServer) takes the step-keyed kinds,
    keyed on its global step index: ``bank_fault@S`` (the bank stepped
    at S raises a transient error), ``heal@S`` (SimServer.heal),
    ``shard_loss@S`` / ``host_loss@S`` (a failover) through
    :meth:`take_serve_fault`, and ``poison_job@J`` (job J's element
    turns NaN after every window it runs, on every retry) through
    :meth:`poisoned`; ``io`` and ``oom`` reach it as they reach a drain.

    Every fired event is appended to :attr:`log`."""

    _KINDS = ("kill", "killsave", "corrupt", "io", "nan", "inf", "scale",
              "stall", "shard_loss", "host_loss", "oom",
              "bank_fault", "heal", "poison_job")

    def __init__(self, spec: str = ""):
        self.events: List[Tuple[str, int]] = []
        self.io_budget = 0
        self.poisoned_jobs: set = set()
        self.log: List[str] = []
        # exchange faults pending for the current window, armed by
        # WindowExecutor.step and taken one per dispatch attempt by
        # dist.guarded_dispatch through take_exchange_fault
        self._stalls_pending = 0
        self._loss_pending = False
        self._host_loss_pending = False
        # injected allocator failures pending, armed by arm_oom and taken
        # one per dispatch attempt by governor.oom_net
        self._oom_pending = 0
        # the payload write runs in a thread beside the metadata write:
        # both may take an injected IO fault
        self._io_lock = threading.Lock()
        spec = (spec or "").strip()
        if spec:
            for part in spec.split(","):
                kind, _, arg = part.strip().partition("@")
                kind = kind.strip()
                if kind not in self._KINDS:
                    raise QuESTError(
                        f"FaultPlan: unknown fault kind {kind!r} "
                        f"(expected one of {self._KINDS})")
                val = int(arg) if arg else 0
                if kind == "io":
                    self.io_budget += val
                elif kind == "poison_job":
                    self.poisoned_jobs.add(val)
                else:
                    self.events.append((kind, val))

    @classmethod
    def from_env(cls) -> Optional["FaultPlan"]:
        spec = os.environ.get("QT_FAULT_PLAN", "")
        return cls(spec) if spec.strip() else None

    def _fire(self, kind: str, window: int) -> bool:
        key = (kind, window)
        if key in self.events:
            self.events.remove(key)
            self.log.append(f"{kind}@{window}")
            return True
        return False

    def maybe_kill(self, window: int) -> None:
        if self._fire("kill", window):
            raise SimulatedPreemption(
                f"injected preemption before window {window}")

    def maybe_kill_mid_save(self, window: int) -> None:
        if self._fire("killsave", window):
            raise SimulatedPreemption(
                f"injected preemption mid-save of window {window}'s "
                "checkpoint (before commit)")

    def should_corrupt(self, window: int) -> bool:
        return self._fire("corrupt", window)

    def arm_exchange_window(self, window: int) -> None:
        """Move this window's ``stall`` / ``shard_loss`` / ``host_loss``
        events into the slots the dispatch-time hook takes from."""
        if self._fire("stall", window):
            self._stalls_pending += 1
        if self._fire("shard_loss", window):
            self._loss_pending = True
        if self._fire("host_loss", window):
            self._host_loss_pending = True
        self.arm_oom(window)

    def arm_oom(self, window: int) -> None:
        """Move window W's ``oom`` events into the slot governor.oom_net
        takes from (arm_exchange_window under run_resumable; a drain
        outside it arms window 0 itself)."""
        while self._fire("oom", window):
            self._oom_pending += 1

    def take_exchange_fault(self, op: str) -> Optional[str]:
        """The dist.EXCHANGE_FAULT_HOOK body: one pending fault per
        dispatch attempt, shard loss first (it preempts the window)."""
        if self._loss_pending:
            self._loss_pending = False
            return "shard_loss"
        if self._host_loss_pending:
            self._host_loss_pending = False
            return "host_loss"
        if self._stalls_pending > 0:
            self._stalls_pending -= 1
            return "stall"
        return None

    def take_oom_fault(self) -> bool:
        """governor.oom_net's hook: one injected allocator failure per
        pending ``oom`` event, taken once per dispatch attempt (one event
        fails the attempt and its retry succeeds; two exhaust the
        retry)."""
        if self._oom_pending > 0:
            self._oom_pending -= 1
            return True
        return False

    def take_serve_fault(self, step: int) -> Optional[str]:
        """SimServer's hook, once per step: fire at most one serve-level
        fault keyed on the server's global step index (banks interleave,
        so a bank's window index would be ambiguous).  Infrastructure
        loss first: it preempts anything else the step could do."""
        for kind in ("host_loss", "shard_loss", "bank_fault", "heal"):
            if self._fire(kind, step):
                return kind
        return None

    def poisoned(self, job_id: int) -> bool:
        """Whether ``poison_job@J`` marks this job id.  Not consumed on
        read: a poisoned job poisons again on every retry, so the
        bisection converges on it instead of exonerating it."""
        return int(job_id) in self.poisoned_jobs

    def take_io_fault(self) -> bool:
        with self._io_lock:
            if self.io_budget > 0:
                self.io_budget -= 1
                self.log.append("io")
                return True
        return False

    def maybe_corrupt_amps(self, qureg, window: int) -> None:
        """nan/inf/scale corruption of the raw amplitudes in place (the
        corruption is physical, like a bit flip: the live permutation is
        kept)."""
        for kind, val in (("nan", float("nan")), ("inf", float("inf")),
                          ("scale", 1.01)):
            if not self._fire(kind, window):
                continue
            pieces = _amp_tensors(qureg._amps_raw())
            if kind == "scale":
                for t in pieces:
                    t.mul_(val)
            else:
                # one poisoned value in the last shard (highest index)
                t = pieces[-1]
                t[0, t.shape[1] - 1] = val


# ---------------------------------------------------------------------------
# Numerical-health watchdog
# ---------------------------------------------------------------------------


def _amp_tensors(amps) -> list:
    """The tensors holding a register's amplitudes: its one tensor, or
    the local shards of a ShardedAmps."""
    from .parallel.mesh import ShardedAmps

    return list(amps.shards) if isinstance(amps, ShardedAmps) else [amps]


def _health_partial(t: torch.Tensor) -> torch.Tensor:
    """(2,) or, for a bank's (B, 2, m) tensor, (2, B): the sum of
    |amp|^2 and a non-finite flag (1 where any value is NaN or Inf),
    each one read of ``t`` (``aminmax`` propagates NaN and Inf)."""
    if t.dim() == 3:
        flat = t.reshape(t.shape[0], -1)
        norm = torch.linalg.vector_norm(flat, dim=1) ** 2
        lo, hi = torch.aminmax(flat, dim=1)
    else:
        norm = torch.linalg.vector_norm(t) ** 2
        lo, hi = torch.aminmax(t)
    bad = ~(torch.isfinite(lo) & torch.isfinite(hi))
    return torch.stack([norm, bad.to(t.dtype)])


def _health_vector(amps) -> np.ndarray:
    """(norm, finite, worst element) of a register or bank: each shard
    reduces its own slice, the partials are summed once (mesh.sum), and
    one readback carries all three.  On a bank the worst element is the
    non-finite one first, else the norm farthest from 1."""
    from .parallel import sharded as SH
    from .parallel.mesh import ShardedAmps

    parts = [_health_partial(t) for t in _amp_tensors(amps)]
    tot = SH.sum_partials(amps, parts) if isinstance(amps, ShardedAmps) \
        else parts[0]
    norms, bad = tot[0], tot[1]
    if norms.dim():
        badness = torch.where(bad > 0, torch.full_like(norms, np.inf),
                              (norms - 1.0).abs())
        elem = torch.argmax(badness)
        norm = norms[elem]
        finite = (bad == 0).all()
    else:
        elem = torch.zeros((), dtype=torch.int64, device=norms.device)
        norm = norms
        finite = bad == 0
    return torch.stack([norm, finite.to(norm.dtype),
                        elem.to(norm.dtype)]).cpu().numpy()


def check_qureg_health(qureg) -> Tuple[float, bool]:
    """(sum |amps|^2, all-finite) of the register, from one reduction on
    its device(s) and one readback.  Pending fused gates drain first; a
    live permutation is kept (both reductions are invariant under it)."""
    out = _health_vector(qureg._amps_raw())
    return float(out[0]), bool(out[1])


def check_bank_health(qureg) -> Tuple[float, bool, int]:
    """:func:`check_qureg_health` plus the worst element of a bank (0 for
    one register), from the same reduction and readback."""
    out = _health_vector(qureg._amps_raw())
    return float(out[0]), bool(out[1]), int(out[2])


WATCHDOG_POLICIES = ("raise", "renormalize", "rollback")


def _health_tolerance(dtype) -> float:
    # norm drift beyond sqrt-eps of the working type means something is
    # wrong (a healthy fused pass keeps the norm to ~eps)
    return 1e-6 if dtype == torch.float64 else 1e-3


# ---------------------------------------------------------------------------
# Generation-based checkpoint protocol
# ---------------------------------------------------------------------------

_LATEST = "LATEST"
_COMMIT = "COMMITTED"
_GENS_KEPT = 2  # last-good + one predecessor (corruption fallback)

# the host copy of a generation's payload: (shape, dtype) -> tensor,
# pinned when the register is on the card; kept for the run's later
# generations and released when run_resumable returns
_STAGE: dict = {}


def _gen_name(cursor: int) -> str:
    return f"gen-{cursor:010d}"


def _gen_cursor(name: str) -> Optional[int]:
    if not name.startswith("gen-"):
        return None
    try:
        return int(name[4:])
    except ValueError:
        return None


def circuit_fingerprint(gates: Sequence, num_qubits: int, every: int) -> str:
    """Content hash binding a checkpoint to (circuit, register width,
    window cadence), the JAX package's for the same gate list: a resume
    under any difference that would change the window plans is refused."""
    h = hashlib.sha256()
    h.update(f"n={num_qubits};every={every};gates={len(gates)};".encode())
    for g in gates:
        h.update(repr(tuple(g.targets)).encode())
        m = g.mat
        if isinstance(m, np.ndarray):
            h.update(m.tobytes())
    return h.hexdigest()


def _host_copy(amps, shape: tuple, dtype: torch.dtype) -> np.ndarray:
    """The raw amplitudes copied into the host staging buffer at their
    global offsets (synchronously), as a NumPy view."""
    from . import checkpoint as CKPT

    pieces = CKPT._pieces(amps)
    key = (tuple(shape), dtype)
    host = _STAGE.get(key)
    if host is None:
        _STAGE.clear()
        host = torch.empty(shape, dtype=dtype, pin_memory=any(
            t.device.type == "cuda" for _o, t in pieces))
        _STAGE[key] = host
    for off, t in pieces:
        host[..., off:off + t.shape[-1]].copy_(t)
    return host.numpy()


def _write_npy(gen: str, arr: np.ndarray) -> None:
    """``<gen>/amps.npy`` from the host array, then fsynced; the write
    and fsync times are observed as checkpoint_write_seconds and
    checkpoint_fsync_seconds."""
    from . import checkpoint as CKPT

    fname = os.path.join(gen, CKPT._AMPS_NAME)
    t0 = time.perf_counter()
    with open(fname, "wb") as f:
        np.lib.format.write_array(f, arr, allow_pickle=False)
        f.flush()
        t1 = time.perf_counter()
        os.fsync(f.fileno())
    t2 = time.perf_counter()
    _telemetry.observe("checkpoint_write_seconds", t1 - t0)
    _telemetry.observe("checkpoint_fsync_seconds", t2 - t1)


def _write_small(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())


def save_generation(qureg, ckpt_dir: str, cursor: int, *,
                    fingerprint: str = "", faults: Optional[FaultPlan] = None,
                    window: int = -1) -> str:
    """Write generation ``cursor`` of ``qureg`` under ``ckpt_dir`` and
    commit it as last good.  The raw (possibly permuted) amplitudes are
    copied to the host synchronously and written in one background
    thread while the metadata (with ``Qureg._perm`` and both measurement
    streams' state) is written; the commit, a COMMITTED marker and an
    atomic rename of LATEST, follows the thread's join and the fsyncs, so
    a crash at any point before it leaves the previous generation
    loadable.

    On torch.distributed ranks every rank calls it with the same
    ``ckpt_dir`` (one directory all of them see), and the generation is
    written by all of them together (``_save_generation_ranks``)."""
    from . import checkpoint as CKPT

    t0 = time.perf_counter()
    ckpt_dir = os.path.abspath(ckpt_dir)
    amps = qureg._amps_raw()  # drain pending gates; keep the live perm
    mesh = CKPT.rank_mesh(amps)
    gen = os.path.join(ckpt_dir, _gen_name(cursor))
    if CKPT.is_writer(mesh):
        os.makedirs(ckpt_dir, exist_ok=True)
        if os.path.exists(gen):  # a stale uncommitted leftover of a crash
            shutil.rmtree(gen)
        os.makedirs(gen)
    if mesh is not None:
        return _save_generation_ranks(qureg, amps, mesh, ckpt_dir, gen,
                                      cursor, fingerprint=fingerprint,
                                      faults=faults, window=window, t0=t0)
    host = _host_copy(amps, CKPT._payload_shape(qureg), qureg.dtype)
    _telemetry.observe("checkpoint_copy_seconds", time.perf_counter() - t0)
    err: list = []

    def write():
        try:
            retry_io(_write_npy, gen, host, what="saveQureg(amps)")
        # qlint: allow(broad-except): the writer thread hands every failure to the committing thread, which re-raises it after the join
        except BaseException as e:
            err.append(e)

    writer = threading.Thread(target=write, name="qt-checkpoint-write")
    writer.start()
    try:
        retry_io(CKPT._write_meta, gen,
                 _generation_meta(qureg, cursor, fingerprint),
                 what="saveQureg(meta)")
    finally:
        writer.join()
    if err:
        raise err[0]
    # ---- commit point ----
    if faults is not None:
        faults.maybe_kill_mid_save(window)
    _commit(ckpt_dir, gen, cursor, faults, window)
    _telemetry.inc("checkpoints_total")
    _telemetry.observe("checkpoint_commit_seconds", time.perf_counter() - t0)
    return gen


def _generation_meta(qureg, cursor: int, fingerprint: str) -> dict:
    """saveQureg's metadata extended with the cursor, the raw permutation,
    the fingerprint and both measurement streams' state."""
    from . import checkpoint as CKPT
    from . import rng as _rng
    from .ops import measurement as M

    meta = CKPT._qureg_meta(qureg)
    meta.update({
        "cursor": int(cursor),
        "perm": list(qureg._perm) if qureg._perm is not None else None,
        "fingerprint": fingerprint,
        "rng": _rng.GLOBAL_RNG.get_state(),
        "measure_keys": M.KEYS.get_state(),
        # a BatchedQureg's per-element measurement key bank
        "batch_keys": qureg.key_state()
        if hasattr(qureg, "key_state") else None,
        # the writing mesh's shard count (load_latest reshards onto
        # any mesh; strict_mesh=True refuses a difference)
        "mesh_shards": int(qureg.num_chunks),
    })
    return meta


def _commit(ckpt_dir: str, gen: str, cursor: int,
            faults: Optional[FaultPlan], window: int) -> None:
    """Commit a written generation: its COMMITTED marker, then the atomic
    rename of LATEST; then the injected corruption and the pruning."""
    _write_small(os.path.join(gen, _COMMIT), _gen_name(cursor) + "\n")
    tmp = os.path.join(ckpt_dir, _LATEST + ".tmp")
    _write_small(tmp, _gen_name(cursor) + "\n")
    os.replace(tmp, os.path.join(ckpt_dir, _LATEST))
    if faults is not None and faults.should_corrupt(window):
        _corrupt_generation(gen)
    _prune_generations(ckpt_dir, keep=_GENS_KEPT)


def _save_generation_ranks(qureg, amps, mesh, ckpt_dir: str, gen: str,
                           cursor: int, *, fingerprint: str,
                           faults: Optional[FaultPlan], window: int,
                           t0: float) -> str:
    """save_generation on torch.distributed ranks: rank 0 (the holder of
    shard 0) has cleared a stale leftover and made the generation's
    directory; it creates the global ``amps.npy``; after a barrier every
    rank writes its own shards' rows at their global offsets and fsyncs
    them; after a second barrier rank 0 writes the metadata and commits,
    and a third barrier returns every rank with the generation committed.
    A kill at the commit point (the same FaultPlan on every rank) leaves
    the previous generation the newest loadable one."""
    from . import checkpoint as CKPT

    writer = CKPT.is_writer(mesh)
    if writer:
        retry_io(CKPT.create_amps, gen, CKPT._payload_shape(qureg),
                 qureg.dtype, what="saveQureg(amps)")
    mesh.barrier()
    t1 = time.perf_counter()
    retry_io(CKPT.write_rows, gen, amps, what="saveQureg(amps)")
    _telemetry.observe("checkpoint_write_seconds", time.perf_counter() - t1)
    mesh.barrier()
    if writer:
        retry_io(CKPT._write_meta, gen,
                 _generation_meta(qureg, cursor, fingerprint),
                 what="saveQureg(meta)")
    # ---- commit point ----
    if faults is not None:
        faults.maybe_kill_mid_save(window)
    if writer:
        _commit(ckpt_dir, gen, cursor, faults, window)
    mesh.barrier()
    _telemetry.inc("checkpoints_total")
    _telemetry.observe("checkpoint_commit_seconds", time.perf_counter() - t0)
    return gen


def _corrupt_generation(gen: str) -> None:
    """Injected corruption: overwrite every data file and the metadata
    with garbage (a torn write, a bad disk)."""
    for root, _dirs, files in os.walk(gen):
        for fname in files:
            if fname == _COMMIT:
                continue
            with open(os.path.join(root, fname), "wb") as f:
                f.write(b"\x00CORRUPT\x00")


def _committed_generations(ckpt_dir: str) -> List[int]:
    """Committed generation cursors, newest first."""
    out = []
    try:
        names = os.listdir(ckpt_dir)
    except OSError:
        return []
    for name in names:
        c = _gen_cursor(name)
        if c is None:
            continue
        if os.path.exists(os.path.join(ckpt_dir, name, _COMMIT)):
            out.append(c)
    return sorted(out, reverse=True)


def latest_committed_cursor(ckpt_dir: str) -> Optional[int]:
    """Cursor of the newest committed generation under ``ckpt_dir``, or
    None."""
    gens = _committed_generations(os.path.abspath(ckpt_dir))
    return gens[0] if gens else None


def _prune_generations(ckpt_dir: str, keep: int) -> None:
    """Drop all but the ``keep`` newest committed generations; an
    uncommitted generation newer than every committed one is an
    in-flight write and is left alone."""
    committed = _committed_generations(ckpt_dir)
    keep_set = {_gen_name(c) for c in committed[:keep]}
    newest = committed[0] if committed else -1
    for name in os.listdir(ckpt_dir):
        c = _gen_cursor(name)
        if c is None or name in keep_set:
            continue
        is_committed = os.path.exists(os.path.join(ckpt_dir, name, _COMMIT))
        if not is_committed and c > newest:
            continue
        shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)


def _validated_perm(perm, n: int):
    """The carried logical->physical permutation of a restore (a bit
    permutation of the global index, valid on any mesh); a malformed one
    (a torn metadata write) raises ValueError, so load_latest treats the
    generation as corrupt."""
    if perm is None:
        return None
    perm = tuple(int(p) for p in perm)
    if sorted(perm) != list(range(n)):
        raise ValueError(
            f"checkpoint perm {perm!r} is not a permutation of "
            f"range({n})")
    return perm


def _load_generation(ckpt_dir: str, cursor: int, env, *,
                     strict_mesh: bool = False):
    from . import checkpoint as CKPT

    gen = os.path.join(ckpt_dir, _gen_name(cursor))
    meta = CKPT._read_meta(gen)
    saved_shards = meta.get("mesh_shards")
    if saved_shards is not None and int(saved_shards) != env.num_devices:
        if strict_mesh:
            raise QuESTError(
                "load_latest: checkpoint mesh mismatch — generation "
                f"{_gen_name(cursor)} was written on {saved_shards} "
                f"shards but this environment has {env.num_devices} "
                "devices, and strict_mesh=True refuses elastic restore")
        # elastic restore: the payload is the global array, cut at the
        # target env's shard boundaries on read
        _telemetry.inc("elastic_restores_total")
        _log_event(meta.get("fingerprint", "")[:12] or "-",
                   "elastic_restore", cursor=int(meta.get("cursor", 0)),
                   from_shards=int(saved_shards),
                   to_shards=int(env.num_devices))
    q = CKPT._qureg_from_meta(meta, env)
    amps = CKPT._restore_amps(gen, q)
    perm = _validated_perm(meta.get("perm"), q.num_qubits_in_state_vec)
    q._set_amps_permuted(amps, perm)
    if meta.get("batch_keys") is not None and hasattr(q, "set_key_state"):
        q.set_key_state(meta["batch_keys"])
    return q, meta


def load_latest(ckpt_dir: str, env, *, strict_mesh: bool = False):
    """Load the newest loadable committed generation under ``ckpt_dir``:
    (qureg, meta), or None when there is no checkpoint.  A corrupt newest
    generation falls back to its predecessor with a warning; an
    environment mismatch (precision, qubit count) is a QuESTError.  The
    restore is elastic: a generation written on M shards loads onto
    ``env``'s N shards; ``strict_mesh=True`` refuses any difference."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    if not os.path.isdir(ckpt_dir):
        return None
    candidates = _committed_generations(ckpt_dir)
    # the LATEST pointer's target first, but never trusted blindly
    try:
        with open(os.path.join(ckpt_dir, _LATEST)) as f:
            pointed = _gen_cursor(f.read().strip())
        if pointed in candidates:
            candidates.remove(pointed)
            candidates.insert(0, pointed)
    except OSError:
        pass
    if not candidates:
        return None
    last_err = None
    for cursor in candidates:
        try:
            loaded = _load_generation(ckpt_dir, cursor, env,
                                      strict_mesh=strict_mesh)
            _telemetry.inc("checkpoint_restores_total")
            return loaded
        except QuESTError:
            raise  # a mismatch of the environment, not corruption
        # qlint: allow(broad-except): corruption shows up as whatever the reader raises (json, numpy, OSError, ...); an unreadable generation falls back to an older one, and the error is warned and chained
        except Exception as e:
            last_err = e
            warnings.warn(
                f"run_resumable: checkpoint generation {cursor} at "
                f"{ckpt_dir} is unreadable ({e!r}); falling back to an "
                "older generation", stacklevel=2)
    raise QuESTError(
        f"run_resumable: no loadable checkpoint generation under "
        f"{ckpt_dir} (last error: {last_err!r})")


# ---------------------------------------------------------------------------
# Window-stepping executor
# ---------------------------------------------------------------------------


class WindowExecutor:
    """Drive a gate stream on a register one fusion window at a time.

    The windows end at :func:`circuit.plan_checkpoint_boundaries`, the
    points where no fused pass is in flight, so between two :meth:`step`
    calls the register can be checkpointed, preempted or interleaved
    with other work.  ``step()`` fires the window's armed faults (kill
    before the window, exchange faults at dispatch)."""

    def __init__(self, qureg, gates: Sequence, *, every: int,
                 start: int = 0, faults: Optional[FaultPlan] = None,
                 fingerprint: str = ""):
        from . import circuit as C

        if every < 1:
            raise QuESTError("WindowExecutor: every must be >= 1")
        self.qureg = qureg
        self.gates = [g if isinstance(g, C.Gate)
                      else C.Gate(tuple(g[0]), g[1]) for g in gates]
        self.every = int(every)
        self.faults = faults
        self.fingerprint = fingerprint
        self.cursor = int(start)
        self._boundaries = C.plan_checkpoint_boundaries(
            len(self.gates), self.every, start=self.cursor)
        self._bi = 0
        # gate range [begin, end) of the last step(), for check_health
        self.last_window: Optional[Tuple[int, int]] = None

    @property
    def done(self) -> bool:
        return self._bi >= len(self._boundaries)

    @property
    def window(self) -> int:
        """Index of the next window (gates [window*every,
        (window+1)*every))."""
        return self.cursor // self.every

    @property
    def num_windows(self) -> int:
        return len(self._boundaries)

    def step(self) -> int:
        """Execute one window [cursor, next boundary) as one fused drain
        and advance the cursor; returns the new cursor (a no-op at the
        end of the stream).  The circuit optimizer is suppressed: the
        cursor indexes the raw gate list, and a resume may land on
        another mesh or permutation (optimizer.suppressed)."""
        from . import fusion as _fusion
        from . import optimizer as _opt

        if self.done:
            return self.cursor
        end = self._boundaries[self._bi]
        if self.faults is not None:
            self.faults.maybe_kill(self.window)
            self.faults.arm_exchange_window(self.window)
        with _opt.suppressed():
            _fusion.start_gate_fusion(self.qureg)
            try:
                self.qureg._fusion.add(*self.gates[self.cursor:end])
            finally:
                _fusion.stop_gate_fusion(self.qureg)  # the window's drain
        self.last_window = (self.cursor, end)
        self.cursor = end
        self._bi += 1
        return end

    def check_health(self) -> None:
        """Health check at the current window boundary: raises
        NumericalHealthError naming the last window's gate range and, on
        a bank, the worst element."""
        q = self.qureg
        norm, finite, elem = check_bank_health(q)
        # density matrices: purity < 1 is legitimate, only finiteness
        norm_bad = (not q.is_density_matrix
                    and abs(norm - 1.0) > _health_tolerance(q.dtype))
        if finite and not norm_bad:
            return
        is_bank = getattr(q, "batch_size", 0) > 1
        desc = ("non-finite amplitudes" if not finite
                else f"norm {norm!r} drifted beyond tolerance")
        raise NumericalHealthError(
            f"health check failed after gates {self.last_window}: {desc}"
            + (f" (worst element {elem})" if is_bank else ""),
            window=self.last_window, norm=norm, finite=finite,
            element=elem if is_bank else None)

    def checkpoint(self, ckpt_dir: str) -> str:
        """Commit a generation at the current cursor (a window
        boundary)."""
        window = max(0, (self.cursor - 1) // self.every)
        return save_generation(self.qureg, ckpt_dir, self.cursor,
                               fingerprint=self.fingerprint,
                               faults=self.faults, window=window)


# ---------------------------------------------------------------------------
# Resumable driver
# ---------------------------------------------------------------------------


def run_resumable(qureg, gates: Sequence, ckpt_dir: str, *, every: int = 64,
                  watchdog: str = "raise",
                  faults: Optional[FaultPlan] = None,
                  elastic: bool = True):
    """Execute ``gates`` (circuit.Gate, or ``(targets, mat)`` pairs on
    state-vector bit positions) on ``qureg`` in fusion windows of
    ``every`` gates, committing a checkpoint generation into ``ckpt_dir``
    after every window.

    If ``ckpt_dir`` holds a committed checkpoint of the same (circuit,
    register, cadence), matched by fingerprint, the run resumes from its
    cursor: the register takes the saved raw amplitudes and permutation,
    both measurement streams take their saved state, and the remaining
    windows produce the uninterrupted run's amplitudes bit for bit.

    ``watchdog``: ``raise`` / ``renormalize`` / ``rollback``.
    ``faults``: a FaultPlan (default: ``QT_FAULT_PLAN``).  ``elastic``
    (default True): a shard loss during a guarded exchange dispatch
    rolls back to the last good generation, shrinks the mesh to the
    surviving half, reshards onto it and resumes (failovers_total, the
    failover_*_seconds gauges, a degradation); with ``elastic=False`` or
    on one shard the ShardLossError propagates.  Returns ``qureg``."""
    from . import circuit as C
    from .parallel import dist as PAR

    if watchdog not in WATCHDOG_POLICIES:
        raise QuESTError(
            f"run_resumable: unknown watchdog policy {watchdog!r} "
            f"(expected one of {WATCHDOG_POLICIES})")
    if every < 1:
        raise QuESTError("run_resumable: every must be >= 1")
    glist = [g if isinstance(g, C.Gate) else C.Gate(tuple(g[0]), g[1])
             for g in gates]
    if faults is None:
        faults = FaultPlan.from_env()
    fp = circuit_fingerprint(glist, qureg.num_qubits_in_state_vec, every)
    run_id = fp[:12]
    t_run = time.perf_counter()

    start = 0
    loaded = load_latest(ckpt_dir, qureg.env)
    if loaded is not None:
        restored, meta = loaded
        if meta.get("fingerprint") not in ("", fp):
            raise QuESTError(
                "run_resumable: checkpoint at "
                f"{ckpt_dir} was written by a different circuit/cadence "
                f"(saved fingerprint {meta.get('fingerprint')!r} != this "
                f"run's {fp!r}); refusing to resume")
        _restore_into(qureg, restored, meta)
        start = int(meta.get("cursor", 0))
        _log_event(run_id, "restore", cursor=start,
                   generation=_gen_name(start), window=start // every,
                   elapsed=round(time.perf_counter() - t_run, 4))

    _ACTIVE_FAULTS[0] = faults
    PAR.EXCHANGE_FAULT_HOOK[0] = (faults.take_exchange_fault
                                  if faults is not None else None)
    # the failover's phase markers: when the current window began
    # (detect = from there to the ShardLossError) and, after a failover,
    # when the resumed run started (resume = to its first window's end)
    marks = {"window_started": None, "resume_from": None}
    try:
        while True:
            try:
                _execute_windows(qureg, glist, ckpt_dir, every=every,
                                 watchdog=watchdog, faults=faults, fp=fp,
                                 run_id=run_id, t_run=t_run, start=start,
                                 marks=marks)
                return qureg
            except PAR.ShardLossError as err:
                start = _failover(qureg, ckpt_dir, err, run_id=run_id,
                                  t_run=t_run, elastic=elastic,
                                  window_started=marks["window_started"])
                marks["resume_from"] = time.perf_counter()
    finally:
        _ACTIVE_FAULTS[0] = None
        PAR.EXCHANGE_FAULT_HOOK[0] = None
        _STAGE.clear()


def _execute_windows(qureg, glist, ckpt_dir: str, *, every: int,
                     watchdog: str, faults: Optional[FaultPlan], fp: str,
                     run_id: str, t_run: float, start: int,
                     marks: dict) -> None:
    """run_resumable's window loop from gate ``start`` on qureg's current
    mesh: each window's drain (WindowExecutor.step), the injected
    amplitude corruption, the watchdog, then a committed generation."""
    ex = WindowExecutor(qureg, glist, every=every, start=start,
                        faults=faults, fingerprint=fp)
    while not ex.done:
        window = ex.window
        begin = ex.cursor
        marks["window_started"] = time.perf_counter()
        end = ex.step()
        if marks["resume_from"] is not None:
            _telemetry.set_gauge("failover_resume_seconds",
                                 time.perf_counter() - marks["resume_from"])
            marks["resume_from"] = None
        if faults is not None:
            faults.maybe_corrupt_amps(qureg, window)
        t_wd = time.perf_counter()
        _watchdog_step(qureg, ckpt_dir, watchdog, (begin, end),
                       log_ctx=(run_id, t_run))
        _telemetry.observe("watchdog_seconds", time.perf_counter() - t_wd)
        t_ck = time.perf_counter()
        with _telemetry.span("resilience.checkpoint", window=window):
            ex.checkpoint(ckpt_dir)
        _log_event(run_id, "checkpoint", window=window, cursor=end,
                   generation=_gen_name(end),
                   seconds=round(time.perf_counter() - t_ck, 4),
                   elapsed=round(time.perf_counter() - t_run, 4))


def _failover(qureg, ckpt_dir: str, err, *, run_id: str, t_run: float,
              elastic: bool, window_started: Optional[float]) -> int:
    """Degraded-mesh failover: roll the register back to the last good
    generation resharded onto the surviving half of the shards, and
    return the gate cursor to resume from.  Re-raises the ShardLossError
    when failover is off or the mesh is one shard; a QuESTError when no
    committed generation exists to roll back to."""
    from . import env as _env

    t_detect = time.perf_counter()
    old_n = qureg.env.num_devices
    if not elastic or old_n <= 1:
        raise err
    new_n = old_n // 2
    detect_s = (t_detect - window_started) if window_started else 0.0
    # a loss that names a shard on a multi-host topology takes its whole
    # host: the surviving mesh is built from intact hosts only
    dead_host = None
    excl = None
    topology = getattr(qureg.env, "topology", None)
    if (err.shard is not None and topology is not None
            and topology.hosts > 1):
        dead_host = topology.host_of(int(err.shard))
        excl = list(topology.host_range(dead_host))
        if old_n - len(excl) < new_n:
            excl = excl[:old_n - new_n]
    # rollback: read the last good generation straight into the shrunken
    # mesh's shards (one restore does the rollback and the reshard IO)
    t0 = time.perf_counter()
    new_env = _env.shrink_env(qureg.env, new_n, exclude_indices=excl)
    loaded = load_latest(ckpt_dir, new_env)
    rollback_s = time.perf_counter() - t0
    if loaded is None:
        raise QuESTError(
            f"run_resumable: shard loss during {err.op!r} dispatch but no "
            f"committed generation exists under {ckpt_dir} to roll back "
            "to; cannot fail over") from err
    # reshard: rebind the register to the degraded mesh and the state
    t1 = time.perf_counter()
    restored, meta = loaded
    qureg.env = new_env
    _restore_into(qureg, restored, meta)
    cursor = int(meta.get("cursor", 0))
    reshard_s = time.perf_counter() - t1
    _telemetry.inc("failovers_total")
    _telemetry.set_gauge("failover_detect_seconds", detect_s)
    _telemetry.set_gauge("failover_rollback_seconds", rollback_s)
    _telemetry.set_gauge("failover_reshard_seconds", reshard_s)
    host_note = (f" (host {dead_host} excluded)"
                 if dead_host is not None else "")
    record_degradation(
        f"mesh_failover_{old_n}to{new_n}",
        f"shard loss during {err.op!r} dispatch ({err}); mesh shrunk "
        f"{old_n}->{new_n}{host_note}, resumed from gate cursor {cursor}")
    _log_event(run_id, "failover", op=err.op, from_shards=old_n,
               to_shards=new_n, cursor=cursor, dead_host=dead_host,
               detect_seconds=round(detect_s, 4),
               rollback_seconds=round(rollback_s, 4),
               reshard_seconds=round(reshard_s, 4),
               elapsed=round(time.perf_counter() - t_run, 4))
    return cursor


def _restore_into(qureg, restored, meta) -> None:
    """Rebind ``qureg`` to a loaded generation's state (raw amplitudes,
    permutation, type) and restore both measurement streams."""
    from . import rng as _rng
    from .ops import measurement as M

    if restored.num_qubits_in_state_vec != qureg.num_qubits_in_state_vec \
            or restored.is_density_matrix != qureg.is_density_matrix:
        raise QuESTError(
            "run_resumable: checkpoint register shape "
            f"({restored.num_qubits_represented} qubits, density="
            f"{restored.is_density_matrix}) does not match the target "
            f"register ({qureg.num_qubits_represented} qubits, density="
            f"{qureg.is_density_matrix})")
    rb = int(getattr(restored, "batch_size", 0) or 0)
    qb = int(getattr(qureg, "batch_size", 0) or 0)
    if rb != qb:
        raise QuESTError(
            "run_resumable: checkpoint batch mismatch — the generation "
            + (f"holds a bank of {rb} elements" if rb
               else "holds a scalar register")
            + " but the target register "
            + (f"is a bank of {qb} elements" if qb else "is scalar")
            + "; a batched checkpoint only restores into a BatchedQureg "
            "of the same batch size")
    qureg.bind_checkpoint_state(restored._amps, restored._perm,
                                restored.dtype)
    if meta.get("batch_keys") is not None \
            and hasattr(qureg, "set_key_state"):
        qureg.set_key_state(meta["batch_keys"])
    if meta.get("rng") is not None:
        _rng.GLOBAL_RNG.set_state(meta["rng"])
    if meta.get("measure_keys") is not None:
        M.KEYS.set_state(meta["measure_keys"])


def _watchdog_step(qureg, ckpt_dir: str, policy: str,
                   window: Tuple[int, int],
                   log_ctx: Optional[Tuple[str, float]] = None) -> None:
    def _verdict(v: str) -> None:
        _telemetry.inc("watchdog_verdicts_total", policy=policy, verdict=v)
        if v != "ok":
            _telemetry.flight_event("watchdog", policy=policy, verdict=v,
                                    window=f"{window[0]}..{window[1]}")
        if log_ctx is not None:
            run_id, t_run = log_ctx
            _log_event(run_id, "watchdog", window=list(window), verdict=v,
                       norm=round(norm, 9), finite=finite,
                       elapsed=round(time.perf_counter() - t_run, 4))

    norm, finite = check_qureg_health(qureg)
    tol = _health_tolerance(qureg.dtype)
    drift = abs(norm - 1.0)
    # density matrices: sum |rho_ij|^2 is the purity, legitimately < 1
    # under noise; only finiteness is checked for them
    norm_bad = (not qureg.is_density_matrix) and drift > tol
    if finite and not norm_bad:
        _verdict("ok")
        return
    desc = ("non-finite amplitudes" if not finite
            else f"norm drift |{norm:.6g} - 1| > {tol:g}")
    msg = (f"numerical-health check failed in window "
           f"[{window[0]}, {window[1]}): {desc}")
    if finite and policy == "renormalize":
        # norm drift only: rescale in place (the live permutation stays)
        scale = float(1.0 / np.sqrt(norm))
        for t in _amp_tensors(qureg._amps_raw()):
            t.mul_(scale)
        warnings.warn(f"run_resumable: {msg}; renormalized", stacklevel=2)
        _verdict("renormalized")
        return
    if policy == "rollback":
        loaded = load_latest(ckpt_dir, qureg.env)
        if loaded is not None:
            restored, meta = loaded
            _restore_into(qureg, restored, meta)
            _verdict("rollback")
            raise NumericalHealthError(
                f"{msg}; rolled back to last-good checkpoint at gate "
                f"cursor {meta.get('cursor', 0)} — re-run run_resumable "
                "to resume from it",
                window=window, norm=norm, finite=finite,
                rolled_back_to=int(meta.get("cursor", 0)))
        _verdict("rollback_failed")
        raise NumericalHealthError(
            f"{msg}; no last-good checkpoint exists to roll back to",
            window=window, norm=norm, finite=finite)
    _verdict("raise")
    raise NumericalHealthError(msg, window=window, norm=norm, finite=finite)
