"""Multi-tenant simulation service: continuous batching with admission
control and preemption (the port of the JAX package's ``serve.py``, with
the same public names, ``QT_SERVE_*`` variables, scheduling decisions and
telemetry series).

Many tenants' small circuits arrive as an open-loop stream and share one
card.  The server composes the layers below it: structure-fingerprinted
register banks (batch.py), window-granular resumable execution
(resilience.py), memory admission (governor.py) and labeled telemetry.
Its piece of its own is CONTINUOUS batching: new work is admitted between
the fusion windows of work already in flight, instead of batch-at-once
draining.

**Execution model.**  :class:`SimServer` is a synchronous scheduling
core driven by repeated :meth:`SimServer.step` calls (the asyncio front
end :class:`Service` steps it between awaits).  One step advances
exactly ONE fusion window of ONE bank:

- submitted jobs land in structure-fingerprinted **buckets** (the
  EnsembleScheduler grouping, extended with the measurement schedule);
- each bucket coalesces waiting jobs into a **bank**, a
  :class:`~quest_tpu_torch.batch.BatchedQureg` padded to a power-of-two
  batch, which stays OPEN (absorbing late arrivals at no cost) until its
  first window executes;
- a started bank advances through a
  :class:`~quest_tpu_torch.resilience.WindowExecutor`, the window-stepping
  loop shared with ``run_resumable``, so between any two windows the
  scheduler can switch banks, admit arrivals, or checkpoint.  A window's
  drain runs the bank's program: its window passes and megawin groups
  are one launch each of K1's and K2's bank forms for the whole bank.

**Scheduling policy.**  Two strict priority classes, ``interactive``
before ``batch``, and weighted fair queuing within a class: each tenant
carries a virtual time advanced by ``share / weight`` whenever a bank
holding its jobs runs a window, and the runnable bank whose owning
tenants have the smallest virtual time goes next (stride scheduling; an
idle tenant's vtime catches up to the clock on its next submit, so idle
periods bank no credit).

**Admission control.**  ``submit`` is the backpressure point: it raises a
structured :class:`QuotaExceededError` (never queues unboundedly) when the
global queue is full, the tenant's pending cap is hit, the tenant's
in-flight bytes exceed its quota, the job could never fit the memory
governor's budget (the ``B x 2 x 2^n x itemsize`` price
``governor.admit_new`` applies at register creation, per device), or the
(tenant, structure) pair is quarantined.

**Preemption.**  When an interactive bank is runnable while batch banks
hold device memory mid-flight, the batch banks are preempted AT THEIR
CURRENT WINDOW BOUNDARY through the resilience generation protocol
(``preempt="checkpoint"``: commit a generation, ``amps.npy`` plus the live
permutation and the per-element key bank, and drop the device bank) or
descheduled while resident (``preempt="pause"``).  A resume reloads the
generation and continues bit for bit as the uninterrupted run.  A bank
that does not fit beside the resident set checkpoints a resident batch
bank to make room.  On an env of torch.distributed ranks every rank runs
the same server and the ranks write each generation together
(checkpoint.py), so they need one checkpoint root that all of them see:
``ckpt_dir`` or ``QT_SERVE_CKPT_DIR``.

**Fault tolerance.**  A bank hit by a transient fault (ShardLossError
with nowhere to shrink, an exchange timeout, checkpoint IO failure) is
DISSOLVED, not failed: its jobs return to their bucket with per-job retry
budgets and decorrelated-jitter backoff (resilience.backoff_delay),
re-bucket into fresh banks, and only exhaust to FAILED, each wrapped per
job in :class:`JobFailedError` with the attempt count and cause chain.
A retried job re-runs from gate 0 under its own measurement seed, so a
job completed under retry equals its fault-free run.  A bank dying of
:class:`~quest_tpu_torch.resilience.NumericalHealthError` or a repeated
allocator failure is BISECTED: the watchdog's worst-element attribution
(or halving when unattributed) re-runs its jobs in smaller banks down to
singletons, the culprit is quarantined behind a per-(tenant, structure)
circuit breaker (``QT_SERVE_QUARANTINE``), and its bank-mates complete.
On a shard or host loss the server FAILS OVER onto the shrunk
in-process mesh (env.shrink_env and the elastic restore) without dropping
queued work; :meth:`SimServer.heal` drains resident banks to checkpoint
boundaries and regrows onto the full mesh through the mesh-portable
restore.

**Observability.**  Every job carries a ``trace_id``; the server threads
it through the lifecycle (admit -> bank_join -> window ->
preempt/resume/retry -> complete or failed) as request-scoped span trees
(:meth:`SimServer.tracez`, ``telemetry.tracez``).  Incidents (quarantine,
failover, allocator-failure bisection, terminal failure) dump the
telemetry flight recorder to JSON under ``QT_SERVE_FLIGHT_DIR``.
:meth:`SimServer.serve_http` starts a stdlib HTTP thread serving
``/metrics`` (``telemetry.prometheus_text()``, byte for byte),
``/healthz`` and ``/tracez``; it reads telemetry and the server's
counters only, never a tensor.

Environment knobs (all optional, constructor arguments win):

- ``QT_SERVE_WINDOW``       gates per fusion window        (default 16)
- ``QT_SERVE_MAX_BATCH``    bank size cap, power of two    (default 16)
- ``QT_SERVE_MAX_PENDING``  global queued-job cap          (default 1024)
- ``QT_SERVE_PREEMPT``      checkpoint | pause | off       (default checkpoint)
- ``QT_SERVE_CKPT_DIR``     preemption checkpoint root     (default: temp dir)
- ``QT_SERVE_RETRIES``      per-job retry budget           (default 3)
- ``QT_SERVE_QUARANTINE``   breaker ``count:open_seconds`` (default 2:30)
- ``QT_SERVE_WATCHDOG``     health-check cadence, windows  (default 8; 0 =
  only at bank completion, which is always checked)
- ``QT_SERVE_FLIGHT_DIR``   incident flight-record dump dir (default:
  ``<ckpt root>/flight``)
- ``QT_SERVE_PREWARM``      1 = queue the observed bank specs, and their
  shrunk-mesh variants, for the warm pool (default 0)

**Warm pool.**  With ``prewarm`` on and the persistent plan cache on
(``QT_AOT_CACHE``, aotcache.py), a thread plans every started bank's
windows ahead of its drains, on the live mesh and on the half mesh a
failover would shrink onto, into the memory tier and onto the disk, so
the drains (and a failover's first degraded windows) load their plans
instead of planning them.  :meth:`SimServer.export_warmset` and
:meth:`SimServer.warm_from` carry the specs to another replica, which
then plans nothing its peer planned.
"""

from __future__ import annotations

import asyncio
import dataclasses
import itertools
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import batch as _batch
from . import circuit as C
from . import governor as _governor
from . import resilience as _resilience
from . import telemetry as _telemetry
from .env import QuESTEnv, shrink_env
from .parallel import dist as _dist
from .parallel import topology as _ptopo
from .validation import QuESTError

__all__ = [
    "INTERACTIVE",
    "BATCH",
    "Job",
    "JobFailedError",
    "QuotaExceededError",
    "Service",
    "SimServer",
    "Tenant",
]

# priority classes, strict order: interactive preempts batch
INTERACTIVE = "interactive"
BATCH = "batch"
_PRIORITIES = (INTERACTIVE, BATCH)
_CLASS_RANK = {INTERACTIVE: 0, BATCH: 1}

# job states
QUEUED = "queued"
RUNNING = "running"
DONE = "done"
FAILED = "failed"

_PREEMPT_MODES = ("checkpoint", "pause", "off")

_WINDOW_ENV = "QT_SERVE_WINDOW"
_MAX_BATCH_ENV = "QT_SERVE_MAX_BATCH"
_MAX_PENDING_ENV = "QT_SERVE_MAX_PENDING"
_PREEMPT_ENV = "QT_SERVE_PREEMPT"
_CKPT_DIR_ENV = "QT_SERVE_CKPT_DIR"
_RETRIES_ENV = "QT_SERVE_RETRIES"
_QUARANTINE_ENV = "QT_SERVE_QUARANTINE"
_WATCHDOG_ENV = "QT_SERVE_WATCHDOG"
_FLIGHT_DIR_ENV = "QT_SERVE_FLIGHT_DIR"
_PREWARM_ENV = "QT_SERVE_PREWARM"

# server serial numbers keep trace ids ("s<serial>-j<jid>") unique across
# SimServer instances sharing one telemetry registry
_SERVER_SEQ = itertools.count()

# bank-dissolve reasons (the serve_bank_retries_total label values)
_RETRY_REASONS = ("transient", "failover", "poison")


class QuotaExceededError(QuESTError):
    """A submission was refused by admission control: the structured
    backpressure signal (an HTTP 429).  ``kind`` names the exhausted
    resource:

    - ``backpressure``: the server's global queued-job cap;
    - ``pending``: the tenant's queued+running job cap;
    - ``bytes``: the tenant's in-flight byte quota;
    - ``memory``: the job could never fit the memory governor's budget
      per device (governor.admit_new's price);
    - ``quarantine``: this (tenant, circuit structure) pair is behind an
      OPEN quarantine circuit breaker (``limit`` is the trip threshold,
      ``value`` the recorded poison verdicts).

    Carries the numbers so clients can retry informed."""

    def __init__(self, msg: str, *, tenant: str, kind: str,
                 limit: float, value: float):
        super().__init__(msg)
        self.tenant = tenant
        self.kind = kind
        self.limit = limit
        self.value = value


class JobFailedError(QuESTError):
    """A job exhausted its retry budget or was quarantined.  Raised by
    :meth:`Job.result` / :meth:`Service.wait`, made fresh per call so
    concurrent callers never share (and mutate the traceback of) one
    exception object.  ``cause`` is the final underlying error (also
    chained as ``__cause__``); ``job.errors`` holds the per-attempt
    chain."""

    def __init__(self, *, tenant: str, jid: int, attempts: int,
                 cause: BaseException):
        super().__init__(
            f"job {jid} (tenant {tenant!r}) failed after {attempts} "
            f"attempt(s): {type(cause).__name__}: {cause}")
        self.tenant = tenant
        self.jid = jid
        self.attempts = attempts
        self.cause = cause


class _Breaker:
    """Per-(tenant, structure fingerprint) quarantine circuit breaker:
    ``closed`` counts poison verdicts, trips ``open`` at the threshold
    (submissions rejected with kind="quarantine"), decays to
    ``half_open`` after ``open_seconds`` (ONE probe admitted), and closes
    again only when a probe completes; another verdict while half-open
    re-opens it at once."""

    __slots__ = ("threshold", "open_seconds", "failures", "opened_at",
                 "state", "probing")

    def __init__(self, threshold: int, open_seconds: float):
        self.threshold = max(1, int(threshold))
        self.open_seconds = float(open_seconds)
        self.failures = 0
        self.opened_at = 0.0
        self.state = "closed"
        self.probing = False

    def record_failure(self) -> None:
        self.failures += 1
        if self.state == "half_open" or self.failures >= self.threshold:
            self.state = "open"
            self.opened_at = time.monotonic()
            self.probing = False

    def record_success(self) -> None:
        if self.state == "half_open":
            self.state = "closed"
            self.failures = 0
        self.probing = False

    def admits(self) -> bool:
        if self.state == "closed":
            return True
        if self.state == "open" \
                and time.monotonic() - self.opened_at >= self.open_seconds:
            self.state = "half_open"
        if self.state == "half_open" and not self.probing:
            self.probing = True
            return True
        return False


class Tenant:
    """Per-tenant scheduling state: a fair-share ``weight`` (bigger = more
    windows per unit of virtual time), a queued+running job cap, and an
    optional in-flight byte quota priced as the governor prices
    registers."""

    def __init__(self, name: str, *, weight: float = 1.0,
                 max_pending: int = 64,
                 max_bytes: Optional[int] = None):
        if weight <= 0:
            raise QuESTError(
                f"Tenant: weight must be > 0, got {weight}")
        self.name = str(name)
        self.weight = float(weight)
        self.max_pending = int(max_pending)
        self.max_bytes = None if max_bytes is None else int(max_bytes)
        self.vtime = 0.0          # weighted-fair virtual time
        self.inflight = 0         # queued + running jobs
        self.inflight_bytes = 0   # modeled bytes of those jobs
        self.submitted = 0
        self.completed = 0

    def __repr__(self):
        return (f"Tenant({self.name!r}, weight={self.weight}, "
                f"inflight={self.inflight}, vtime={self.vtime:.3f})")


class Job:
    """One submitted circuit.  Lifecycle: ``queued`` -> ``running`` (its
    bank's first window executed) -> ``done`` / ``failed``.  On completion
    :attr:`amps` holds the element's canonical (2, 2^n) amplitudes as a
    host tensor (after the measurements when a schedule was given),
    :attr:`outcomes` the ``(outcome, probability)`` pair of each measured
    qubit in schedule order, and :attr:`key_state` the element's final
    measurement key and shot counter (BatchedQureg.key_state's element),
    so clients can audit the random stream."""

    __slots__ = ("id", "tenant", "gates", "num_qubits", "priority",
                 "seed", "measure", "state", "amps", "outcomes",
                 "key_state", "error", "errors", "bytes", "t_submit",
                 "t_start", "t_done", "attempts", "not_before",
                 "backoff", "bisect_group", "trace_id")

    def __init__(self, jid: int, tenant: str, gates: list,
                 num_qubits: int, priority: str, seed, measure: tuple,
                 nbytes: int):
        self.id = jid
        self.tenant = tenant
        self.gates = gates
        self.num_qubits = num_qubits
        self.priority = priority
        self.seed = seed
        self.measure = measure
        self.bytes = nbytes
        self.state = QUEUED
        self.amps = None
        self.outcomes: List[Tuple[int, float]] = []
        self.key_state: Optional[dict] = None
        self.error: Optional[BaseException] = None
        self.errors: List[str] = []   # per-attempt failure chain
        self.t_submit = time.perf_counter()
        self.t_start: Optional[float] = None
        self.t_done: Optional[float] = None
        self.attempts = 0             # banks this job has started in
        self.not_before = 0.0         # retry backoff gate (monotonic)
        self.backoff: Optional[float] = None  # last backoff delay
        # quarantine bisection: (group tag, bank-size cap) or None; jobs
        # share a bank only with the same group
        self.bisect_group: Optional[Tuple[str, int]] = None
        # request-scoped trace id ("s<serial>-j<jid>", set at admit)
        self.trace_id = ""

    @property
    def done(self) -> bool:
        return self.state in (DONE, FAILED)

    def _failure(self) -> JobFailedError:
        return JobFailedError(tenant=self.tenant, jid=self.id,
                              attempts=max(1, self.attempts),
                              cause=self.error)

    def result(self):
        """The final amplitudes; a failed job raises a fresh
        :class:`JobFailedError`, and one still in flight refuses."""
        if self.state == FAILED:
            raise self._failure() from self.error
        if self.state != DONE:
            raise QuESTError(
                f"Job {self.id}: result() before completion "
                f"(state={self.state!r}) — drive the server "
                "(step/run_until_idle) or await Service.wait")
        return self.amps

    def __repr__(self):
        return (f"Job(id={self.id}, tenant={self.tenant!r}, "
                f"priority={self.priority!r}, state={self.state!r})")


class _Bank:
    """One padded batch of same-fingerprint jobs moving through a
    WindowExecutor.  OPEN until its first window (jobs may still join);
    then RUNNING, possibly PREEMPTED (device state checkpointed and
    dropped, or descheduled under ``pause``), and finally drained and
    finalized."""

    __slots__ = ("seq", "key", "jobs", "num_qubits", "is_density",
                 "measure", "priority", "qureg", "ex", "items", "B",
                 "started", "preempted", "paused", "cursor", "sfp",
                 "ckpt_dir", "group")

    def __init__(self, seq: int, key: tuple, num_qubits: int,
                 is_density: bool, measure: tuple,
                 group: Optional[Tuple[str, int]] = None):
        self.seq = seq
        self.key = key
        self.group = group  # quarantine-bisection cohort (job.bisect_group)
        self.jobs: List[Job] = []
        self.num_qubits = num_qubits
        self.is_density = is_density
        self.measure = measure
        self.priority = BATCH
        self.qureg = None
        self.ex: Optional[_resilience.WindowExecutor] = None
        self.items: Optional[list] = None
        self.B = 0
        self.started = False
        self.preempted = False
        self.paused = False
        self.cursor = 0
        self.sfp = ""
        self.ckpt_dir = ""

    def add(self, job: Job) -> None:
        self.jobs.append(job)
        if _CLASS_RANK[job.priority] < _CLASS_RANK[self.priority]:
            self.priority = job.priority

    @property
    def running(self) -> bool:
        return self.started and self.ex is not None \
            and not self.ex.done

    def min_vtime(self, tenants: Dict[str, Tenant]) -> float:
        return min(tenants[j.tenant].vtime for j in self.jobs)


def _env_int(var: str, default: int) -> int:
    raw = os.environ.get(var, "").strip()
    return int(raw) if raw else default


class _PlanStub:
    """The register-shaped parameters a bank's plans depend on (env,
    width, batch, dtype, starting permutation), for planning a bank's
    windows ahead of it without allocating amplitudes: the warm pool's
    unit of work."""

    __slots__ = ("env", "num_qubits_in_state_vec", "_perm", "_amps",
                 "batch_size", "dtype", "num_amps_total", "shard_bits",
                 "is_sharded", "device")

    def __init__(self, env: QuESTEnv, n: int, batch: int, dtype):
        self.env = env
        self.num_qubits_in_state_vec = n
        self._perm = None  # banks (re)start drains from canonical order
        self._amps = None
        self.batch_size = batch
        self.dtype = getattr(torch, dtype) if isinstance(dtype, str) \
            else dtype
        self.num_amps_total = 1 << n
        nd = env.num_devices
        # Qureg.shard_bits for this width on this env
        self.shard_bits = 0 if nd <= 1 or self.num_amps_total < nd \
            else nd.bit_length() - 1
        self.is_sharded = self.shard_bits > 0
        self.device = env.device


def _job_bytes_per_device(num_qubits: int, env: QuESTEnv,
                          is_density: bool, batch: int = 1) -> int:
    """Modeled footprint per device of ``batch`` elements of a
    ``num_qubits``-qubit register, ``B x 2 x 2^n x itemsize`` split over
    the env's shards: governor.register_bytes_per_device's price, from
    parameters, so admission can price a job before any register
    exists."""
    from . import precision as P

    n = num_qubits * (2 if is_density else 1)
    amps = 1 << n
    total = batch * 2 * amps * _governor._itemsize(P.real_dtype())
    if env.mesh is not None and amps >= env.num_devices:
        return total // env.num_devices
    return total


def _host_bank(q) -> torch.Tensor:
    """A bank's canonical (B, 2, 2^n) amplitudes as one host tensor (a
    copy, so the jobs share nothing with the register)."""
    from .parallel.mesh import ShardedAmps
    from .parallel import sharded as SH

    amps = q.amps
    if isinstance(amps, ShardedAmps):
        return torch.from_numpy(SH.gather_host(amps))
    return amps.detach().to("cpu", copy=True)


class SimServer:
    """The synchronous multi-tenant scheduling core (see the module
    docstring for the execution model).  Drive it with :meth:`step` (one
    window of one bank) or :meth:`run_until_idle`; wrap it in
    :class:`Service` for an asyncio front end.

    Parameters default from the ``QT_SERVE_*`` environment knobs;
    explicit arguments win.  ``max_batch`` must be a power of two (the
    EnsembleScheduler bucket rule)."""

    def __init__(self, env: QuESTEnv, *, window: Optional[int] = None,
                 max_batch: Optional[int] = None,
                 max_pending: Optional[int] = None,
                 preempt: Optional[str] = None,
                 ckpt_dir: Optional[str] = None,
                 retries: Optional[int] = None,
                 quarantine: Optional[Tuple[int, float]] = None,
                 watchdog: Optional[int] = None,
                 faults: Optional[_resilience.FaultPlan] = None,
                 prewarm: Optional[bool] = None):
        from .parallel.mesh import InProcessMesh

        self.env = env
        self.window = window if window is not None \
            else _env_int(_WINDOW_ENV, 16)
        self.max_batch = max_batch if max_batch is not None \
            else _env_int(_MAX_BATCH_ENV, 16)
        self.max_pending = max_pending if max_pending is not None \
            else _env_int(_MAX_PENDING_ENV, 1024)
        self.preempt = preempt if preempt is not None \
            else (os.environ.get(_PREEMPT_ENV, "").strip()
                  or "checkpoint")
        if self.window < 1:
            raise QuESTError(
                f"SimServer: window must be >= 1, got {self.window}")
        if self.max_batch < 1 or (self.max_batch & (self.max_batch - 1)):
            raise QuESTError(
                f"SimServer: max_batch must be a power of two, got "
                f"{self.max_batch}")
        if self.preempt not in _PREEMPT_MODES:
            raise QuESTError(
                f"SimServer: unknown preempt mode {self.preempt!r} "
                f"(expected one of {_PREEMPT_MODES})")
        root = ckpt_dir or os.environ.get(_CKPT_DIR_ENV, "").strip()
        if self.preempt == "checkpoint" and not root \
                and env.mesh is not None \
                and not isinstance(env.mesh, InProcessMesh):
            # the ranks write each generation together, into one
            # directory; a temporary one would differ from rank to rank
            raise QuESTError(
                "SimServer: preempt='checkpoint' on torch.distributed "
                "ranks needs a checkpoint root every rank sees: pass "
                "ckpt_dir= or set QT_SERVE_CKPT_DIR")
        self._own_ckpt_root = not root
        self._ckpt_root = root or tempfile.mkdtemp(prefix="qt_serve_")
        self.retries = retries if retries is not None \
            else _env_int(_RETRIES_ENV, 3)
        if quarantine is None:
            raw = os.environ.get(_QUARANTINE_ENV, "").strip() or "2:30"
            thr, _, secs = raw.partition(":")
            quarantine = (int(thr), float(secs or "30"))
        self._q_threshold = max(1, int(quarantine[0]))
        self._q_open_seconds = float(quarantine[1])
        self.watchdog = watchdog if watchdog is not None \
            else _env_int(_WATCHDOG_ENV, 8)
        self.faults = faults if faults is not None \
            else _resilience.FaultPlan.from_env()
        self._backoff_base = float(
            os.environ.get(_resilience._RETRY_BASE_ENV, "0.05"))
        self.tenants: Dict[str, Tenant] = {}
        self._buckets: Dict[tuple, List[Job]] = {}
        self._banks: List[_Bank] = []
        self._breakers: Dict[tuple, _Breaker] = {}
        self._next_job = 0
        self._next_bank = 0
        self._vclock = 0.0
        self._queued = 0
        self._closed = False
        self.completed = 0
        self._step_count = 0
        self._inject_bank_fault = False
        # the environment to heal back onto (degraded = env is not this)
        self._full_env = env
        # a declared shard or host loss (dist.guarded_dispatch)
        # invalidates the governor's budget per device the moment it is
        # announced, before the ShardLossError unwinds to _advance
        self._mesh_cb = lambda _event, _info: _governor.refresh_budget()
        _ptopo.add_mesh_listener(self._mesh_cb)
        self._serial = next(_SERVER_SEQ)
        self._flight_dir = os.environ.get(_FLIGHT_DIR_ENV, "").strip() \
            or os.path.join(self._ckpt_root, "flight")
        self.flight_dumps: List[str] = []
        self._http = None
        self._http_thread: Optional[threading.Thread] = None
        # the warm pool: a daemon thread takes every observed bank spec,
        # on the live mesh and on the next failover's shrunk mesh, off the
        # scheduling thread
        self.prewarm = bool(prewarm) if prewarm is not None \
            else bool(_env_int(_PREWARM_ENV, 0))
        self._warm_specs: Dict[tuple, dict] = {}  # dedup key -> spec
        self._warm_keys: set = set()              # specs warmed so far
        self._prewarm_q: List[tuple] = []
        self._prewarm_pending = 0
        self._prewarm_lock = threading.Lock()
        self._prewarm_wake = threading.Condition(self._prewarm_lock)
        self._prewarm_thread: Optional[threading.Thread] = None
        _telemetry.set_gauge("serve_degraded", 0.0)

    # -- tenants ---------------------------------------------------------

    def register_tenant(self, name: str, *, weight: float = 1.0,
                        max_pending: int = 64,
                        max_bytes: Optional[int] = None) -> Tenant:
        """Create (or reconfigure) a tenant.  Unregistered tenant names
        are created at their first submit with the default limits."""
        t = self.tenants.get(name)
        if t is None:
            t = Tenant(name, weight=weight, max_pending=max_pending,
                       max_bytes=max_bytes)
            t.vtime = self._vclock
            self.tenants[name] = t
        else:
            t.weight = float(weight)
            t.max_pending = int(max_pending)
            t.max_bytes = None if max_bytes is None else int(max_bytes)
        return t

    # -- admission -------------------------------------------------------

    def submit(self, gates: Sequence, *, num_qubits: int,
               tenant: str = "default", priority: str = BATCH,
               seed=None, measure: Sequence[int] = (),
               is_density_matrix: bool = False) -> Job:
        """Queue one circuit; returns its :class:`Job` handle.  ``gates``
        is a sequence of :class:`quest_tpu_torch.circuit.Gate` (or
        ``(targets, mat)`` pairs) with concrete NumPy SoA matrices, the
        EnsembleScheduler submission format; ``measure`` schedules qubit
        measurements (in order) after the last gate and is part of the
        batching fingerprint, so only identically measured circuits share
        a bank.  ``seed`` gives the element its measurement stream
        (default: the job id).

        Raises :class:`QuotaExceededError` instead of queueing beyond any
        limit: admission control IS the backpressure."""
        if self._closed:
            raise QuESTError("SimServer: submit after close()")
        if priority not in _PRIORITIES:
            raise QuESTError(
                f"SimServer.submit: unknown priority {priority!r} "
                f"(expected one of {_PRIORITIES})")
        gates = [g if isinstance(g, C.Gate) else C.Gate(tuple(g[0]), g[1])
                 for g in gates]
        for g in gates:
            if not isinstance(g.mat, np.ndarray):
                raise QuESTError(
                    "SimServer.submit: gate matrices must be concrete "
                    "numpy arrays (they are stacked across submissions)")
        t = self.tenants.get(tenant)
        if t is None:
            t = self.register_tenant(tenant)
        if self._queued >= self.max_pending:
            self._reject(t, "backpressure", self.max_pending,
                         self._queued)
        if t.inflight >= t.max_pending:
            self._reject(t, "pending", t.max_pending, t.inflight)
        nbytes = _job_bytes_per_device(int(num_qubits), self.env,
                                       is_density_matrix)
        if t.max_bytes is not None \
                and t.inflight_bytes + nbytes > t.max_bytes:
            self._reject(t, "bytes", t.max_bytes,
                         t.inflight_bytes + nbytes)
        budget = _governor.budget_bytes(self.env)
        if _governor.enabled(self.env) and budget is not None \
                and nbytes > budget:
            self._reject(t, "memory", budget, nbytes)
        measure = tuple(int(m) for m in measure)
        for qb in measure:
            if not 0 <= qb < int(num_qubits):
                raise QuESTError(
                    f"SimServer.submit: measured qubit {qb} out of "
                    f"range for {num_qubits} qubits")
        key = (_batch._structure_fingerprint(
            gates, int(num_qubits), bool(is_density_matrix)), measure)
        br = self._breakers.get((t.name, key))
        if br is not None and not br.admits():
            self._reject(t, "quarantine", self._q_threshold, br.failures)
        jid = self._next_job
        self._next_job += 1
        job = Job(jid, t.name, gates, int(num_qubits), priority,
                  seed, measure, nbytes)
        self._buckets.setdefault(key, []).append(job)
        # an idle tenant's vtime catches up to the scheduler clock so
        # idle periods bank no fair-share credit
        t.vtime = max(t.vtime, self._vclock)
        t.inflight += 1
        t.inflight_bytes += nbytes
        t.submitted += 1
        self._queued += 1
        job.trace_id = f"s{self._serial}-j{jid}"
        _telemetry.trace_begin(job.trace_id, "job", tenant=t.name,
                               priority=priority,
                               qubits=int(num_qubits))
        _telemetry.trace_point(job.trace_id, "serve.admit",
                               queue_depth=self._queued)
        _telemetry.inc("serve_jobs_submitted_total", tenant=t.name)
        _telemetry.set_gauge("serve_queue_depth", self._queued)
        return job

    def _reject(self, t: Tenant, kind: str, limit, value) -> None:
        _telemetry.inc("serve_jobs_rejected_total", tenant=t.name,
                       kind=kind)
        _telemetry.flight_event("admission_rejected", tenant=t.name,
                                reason=kind, limit=limit, value=value)
        raise QuotaExceededError(
            f"SimServer.submit: tenant {t.name!r} over {kind} limit "
            f"({value} > {limit}) — back off and retry",
            tenant=t.name, kind=kind, limit=float(limit),
            value=float(value))

    # -- continuous batching: bucket -> bank coalescing ------------------

    def _form_banks(self) -> None:
        """Move waiting jobs into banks.  A bucket's newest bank stays
        OPEN (absorbing arrivals) until its first window executes: the
        continuous-batching admission point, where work arriving while
        other banks execute coalesces instead of waiting for a global
        drain.  Jobs backing off after a dissolve (``not_before`` in the
        future) wait; jobs in a bisection cohort share a bank only with
        their cohort, capped at its size."""
        now = time.monotonic()
        for key, waiting in self._buckets.items():
            if not waiting:
                continue
            taken: List[Job] = []
            for job in waiting:
                if job.not_before > now:
                    continue
                group = job.bisect_group
                cap = group[1] if group is not None else self.max_batch
                bank = next((b for b in self._banks
                             if b.key == key and b.group == group
                             and not b.started and len(b.jobs) < cap),
                            None)
                if bank is None:
                    sfp, measure = key
                    bank = _Bank(self._next_bank, key,
                                 num_qubits=job.num_qubits,
                                 is_density=bool(sfp[0][2]),
                                 measure=measure, group=group)
                    self._next_bank += 1
                    self._banks.append(bank)
                bank.add(job)
                taken.append(job)
            for job in taken:
                waiting.remove(job)

    def _start(self, bank: _Bank) -> None:
        """Close an open bank: pad to a power-of-two batch, build the
        bank's gate items (shared matrices collapse, per-element ones
        stack), create the governed register and arm its
        WindowExecutor."""
        from . import api as _api

        jobs = bank.jobs
        real = len(jobs)
        cap = bank.group[1] if bank.group is not None else self.max_batch
        bank.B = _batch._bucket_size(real, cap)
        padded = jobs + [jobs[-1]] * (bank.B - real)
        seeds = [j.seed if j.seed is not None else j.id for j in padded]
        q = _batch.createBatchedQureg(
            bank.num_qubits, self.env, bank.B,
            is_density_matrix=bank.is_density, seeds=seeds)
        bank.items = _batch.bank_gate_items(
            [j.gates for j in padded], bank.num_qubits,
            bank.is_density, qureg=q)
        _telemetry.inc_key(_api._K_UNITARY,
                           bank.B * len(jobs[0].gates))
        bank.sfp = _resilience.circuit_fingerprint(
            bank.items, q.num_qubits_in_state_vec, self.window)
        bank.ckpt_dir = os.path.join(self._ckpt_root,
                                     f"bank-{bank.seq}")
        bank.qureg = q
        bank.ex = _resilience.WindowExecutor(
            q, bank.items, every=self.window, fingerprint=bank.sfp)
        bank.started = True
        now = time.perf_counter()
        for j in jobs:
            j.state = RUNNING
            j.t_start = now
            j.attempts += 1
            self._queued -= 1
            _telemetry.observe("serve_queue_wait_seconds",
                               now - j.t_submit, tenant=j.tenant)
            _telemetry.trace_point(j.trace_id, "serve.bank_join",
                                   bank=bank.seq, attempt=j.attempts,
                                   batch=bank.B)
        _telemetry.inc("serve_banks_total")
        _telemetry.set_gauge("serve_queue_depth", self._queued)
        self._publish_occupancy(bank)
        self._refresh_watermark()
        self._warm_variants(bank)

    def _publish_occupancy(self, bank: _Bank) -> None:
        occ = _batch.bank_occupancy(bank.qureg, real=len(bank.jobs))
        _telemetry.set_gauge("serve_bank_occupancy", occ["occupancy"])
        _telemetry.observe("ensemble_bucket_occupancy",
                           occ["occupancy"])
        per_tenant: Dict[str, int] = {}
        for j in bank.jobs:
            per_tenant[j.tenant] = per_tenant.get(j.tenant, 0) + 1
        for name, count in per_tenant.items():
            _telemetry.set_gauge("bank_occupancy", count / bank.B,
                                 tenant=name)

    # -- preemption protocol ---------------------------------------------

    def _release_device(self, bank: _Bank) -> None:
        """Drop a bank's register: its governor ledger entry and every
        reference the server holds, so its device memory is freed."""
        if bank.qureg is not None:
            _governor.release(bank.qureg)
        bank.qureg = None
        bank.ex = None

    def _preempt(self, bank: _Bank) -> None:
        """Preempt a mid-flight bank at its current window boundary.
        ``checkpoint`` commits a resilience generation (raw permuted
        amplitudes, the live permutation, the per-element key bank) and
        DROPS the device state, freeing its governed footprint; ``pause``
        only deschedules it (the state stays resident)."""
        if self.preempt == "off" or not bank.running or bank.paused:
            return
        _telemetry.inc("preemptions_total", mode=self.preempt)
        if _telemetry.enabled():
            for j in bank.jobs:
                _telemetry.trace_point(j.trace_id, "serve.preempt",
                                       bank=bank.seq,
                                       mode=self.preempt)
        if self.preempt == "pause":
            bank.paused = True
            return
        with _telemetry.span("serve.preempt", bank=bank.seq):
            bank.ex.checkpoint(bank.ckpt_dir)
        bank.cursor = bank.ex.cursor
        self._release_device(bank)
        bank.preempted = True

    def _resume(self, bank: _Bank) -> None:
        """Reload a checkpoint-preempted bank and continue from its saved
        cursor: the other half of the bit-identical preemption
        contract."""
        with _telemetry.span("serve.resume", bank=bank.seq):
            loaded = _resilience.load_latest(bank.ckpt_dir, self.env)
        if loaded is None:
            raise QuESTError(
                f"SimServer: preempted bank {bank.seq} has no loadable "
                f"generation under {bank.ckpt_dir}")
        q, meta = loaded
        cursor = int(meta.get("cursor", 0))
        if cursor != bank.cursor:
            raise QuESTError(
                f"SimServer: bank {bank.seq} checkpoint cursor "
                f"{cursor} != preemption cursor {bank.cursor}")
        bank.qureg = q
        bank.ex = _resilience.WindowExecutor(
            q, bank.items, every=self.window, start=cursor,
            fingerprint=bank.sfp)
        bank.preempted = False
        _telemetry.inc("serve_resumes_total")
        if _telemetry.enabled():
            for j in bank.jobs:
                _telemetry.trace_point(j.trace_id, "serve.resume",
                                       bank=bank.seq, cursor=cursor)

    # -- scheduling ------------------------------------------------------

    def _runnable(self) -> List[_Bank]:
        return [b for b in self._banks
                if b.jobs and (not b.started or b.preempted
                               or b.paused or b.running)]

    def _pick(self) -> Optional[_Bank]:
        """Strict priority class, then weighted fair (smallest owning
        vtime), then bank age."""
        runnable = self._runnable()
        if not runnable:
            return None
        return min(runnable, key=lambda b: (
            _CLASS_RANK[b.priority], b.min_vtime(self.tenants), b.seq))

    def _charge(self, bank: _Bank) -> None:
        per_tenant: Dict[str, int] = {}
        for j in bank.jobs:
            per_tenant[j.tenant] = per_tenant.get(j.tenant, 0) + 1
        for name, count in per_tenant.items():
            t = self.tenants[name]
            t.vtime += (count / len(bank.jobs)) / t.weight
            self._vclock = max(self._vclock, t.vtime)

    def step(self) -> bool:
        """One scheduling quantum: coalesce arrivals into banks, pick the
        next bank under the policy, preempt lower-priority work if the
        pick is interactive, and advance the pick by ONE fusion window
        (finalizing it when its stream ends).  Returns False when nothing
        is runnable (the idle signal for drivers); jobs merely backing
        off still count as runnable: the step waits out the earliest
        ``not_before`` instead of reporting idle."""
        if self._closed:
            return False
        step_idx = self._step_count
        self._step_count += 1
        plan = self.faults
        installed = False
        if plan is not None:
            kind = plan.take_serve_fault(step_idx)
            if kind == "heal":
                self.heal()
            elif kind in ("host_loss", "shard_loss"):
                # a host loss names its observed shard (the highest
                # index); a bare shard loss is anonymous: sub-host shrink
                shard = self.env.num_devices - 1 \
                    if kind == "host_loss" else None
                self._failover(_dist.ShardLossError(
                    f"injected {kind} at serve step {step_idx}",
                    op="serve", shard=shard))
            elif kind == "bank_fault":
                self._inject_bank_fault = True
            # io and oom events flow through the shared slots retry_io
            # and governor.oom_net read while this step runs
            plan.arm_oom(step_idx)
            if _resilience._ACTIVE_FAULTS[0] is None:
                _resilience._ACTIVE_FAULTS[0] = plan
                installed = True
        try:
            self._form_banks()
            bank = self._pick()
            if bank is None:
                gates = [j.not_before for w in self._buckets.values()
                         for j in w]
                if not gates:
                    return False
                # everything queued is backing off: wait (bounded) for
                # the earliest retry gate rather than going idle
                delay = min(gates) - time.monotonic()
                if delay > 0:
                    time.sleep(min(delay, 0.05))
                return True
            if bank.priority == INTERACTIVE and self.preempt != "off":
                for other in self._banks:
                    if other is not bank and other.priority == BATCH:
                        try:
                            self._preempt(other)
                        except (QuESTError, OSError, TimeoutError) as e:
                            # checkpoint IO died mid-preempt: the device
                            # state is suspect; dissolve and retry
                            self._dissolve(other, e, reason="transient")
            self._advance(bank)
            return True
        finally:
            if installed:
                _resilience._ACTIVE_FAULTS[0] = None

    def _advance(self, bank: _Bank) -> None:
        try:
            if self._inject_bank_fault:
                self._inject_bank_fault = False
                raise TimeoutError(
                    f"injected bank fault (chaos) on bank {bank.seq}")
            if not bank.started:
                self._start(bank)
            elif bank.preempted:
                self._resume(bank)
            bank.paused = False
            w = bank.ex.window
            t0 = time.perf_counter()
            with _telemetry.span("serve.window", bank=bank.seq,
                                 window=w):
                bank.ex.step()
            if _telemetry.enabled():
                dur = time.perf_counter() - t0
                for j in bank.jobs:
                    _telemetry.trace_add(j.trace_id, "serve.window",
                                         t0=t0, dur=dur,
                                         bank=bank.seq, window=w)
            _telemetry.inc("serve_windows_total")
            self._charge(bank)
            self._maybe_poison(bank)
            if bank.ex.done or self._watchdog_due(bank):
                bank.ex.check_health()
            if bank.ex.done:
                self._finalize(bank)
        except _dist.ShardLossError as e:
            # infrastructure loss: fail over EVERYTHING onto the shrunk
            # mesh; this bank's jobs retry or resume there
            self._failover(e)
        except _resilience.NumericalHealthError as e:
            # poisoned amplitudes: bisect toward the culprit (before the
            # QuESTError arm: it is a subclass)
            self._quarantine_or_bisect(bank, e)
        except _governor.MemoryAdmissionError as e:
            # the bank does not fit beside the resident set: checkpoint a
            # lower-priority resident bank and retry the start on a later
            # step; with nothing left to evict the refusal is final
            _telemetry.inc("serve_admission_stalls_total")
            if not self._preempt_for_memory(bank):
                self._fail(bank, e)
        # qlint: allow(oom-swallow): classification only: the governor's oom_net already spent its evict-and-retry, and the verdict routes the bank to bisection, never to another allocation
        except (QuESTError, OSError, TimeoutError) as e:
            # transient (exhausted IO retries, exchange timeout, injected
            # bank fault): dissolve, and the jobs retry in fresh banks
            # against their budgets.  A repeated allocator failure
            # bisects instead.
            if _governor._is_oom(e):
                self._quarantine_or_bisect(bank, e)
            else:
                self._dissolve(bank, e, reason="transient")
        # qlint: allow(oom-swallow): the same classification after the oom_net as above
        except RuntimeError as e:
            # the governor's OOM net retries once and re-raises
            # (torch.OutOfMemoryError is a RuntimeError): a bank that
            # still fails to allocate is bisected like poison; any other
            # RuntimeError is a bug and propagates
            if _governor._is_oom(e):
                self._quarantine_or_bisect(bank, e)
            else:
                raise

    def _watchdog_due(self, bank: _Bank) -> bool:
        """Health-check cadence: every ``watchdog``-th executed window of
        a bank (0 disables the periodic check; bank completion is always
        checked in _advance)."""
        if self.watchdog <= 0 or bank.ex is None:
            return False
        return bank.ex.window % self.watchdog == 0

    def _maybe_poison(self, bank: _Bank) -> None:
        """Chaos injection: NaN-poison the bank element of any resident
        job marked ``poison_job@J`` in the fault plan.  Persistent by
        design: the job poisons again on every retry, so the bisection
        converges on it."""
        plan = self.faults
        if plan is None or not plan.poisoned_jobs or bank.qureg is None:
            return
        for i, j in enumerate(bank.jobs):
            if not plan.poisoned(j.id):
                continue
            q = bank.qureg
            # the element's last amplitude of the raw state, in its last
            # shard (a physical fault: the live permutation is kept)
            last = _resilience._amp_tensors(q._amps_raw())[-1]
            last[i, 0, last.shape[-1] - 1] = float("nan")
            plan.log.append(f"poison_job@{j.id}")

    def _preempt_for_memory(self, needy: _Bank) -> bool:
        """Free governed bytes for ``needy`` by checkpoint-preempting one
        resident batch-class bank.  False when nothing is evictable
        (pause keeps state resident, so it cannot help)."""
        if self.preempt != "checkpoint":
            return False
        for other in self._banks:
            if other is not needy and other.qureg is not None \
                    and other.started and other.priority == BATCH \
                    and other.running:
                self._preempt(other)
                return True
        return False

    # -- fault tolerance: dissolve / quarantine / failover / heal --------

    def _drop_bank(self, bank: _Bank) -> None:
        """Release a bank's device state and remove it from scheduling
        (its jobs are the caller's)."""
        self._release_device(bank)
        if bank in self._banks:
            self._banks.remove(bank)
        if bank.ckpt_dir and os.path.isdir(bank.ckpt_dir):
            shutil.rmtree(bank.ckpt_dir, ignore_errors=True)

    def _fail_job(self, job: Job, err: BaseException, *,
                  quarantined: bool = False) -> None:
        """Terminal per-job failure: records the cause for
        :meth:`Job.result`'s JobFailedError and settles accounting."""
        if job.t_start is None and job.state == QUEUED:
            self._queued -= 1
        job.state = FAILED
        job.error = err
        job.errors.append(
            f"attempt {max(1, job.attempts)}: "
            f"{type(err).__name__}: {err}")
        job.t_done = time.perf_counter()
        t = self.tenants[job.tenant]
        t.inflight -= 1
        t.inflight_bytes -= job.bytes
        _telemetry.trace_point(job.trace_id, "serve.failed",
                               error=type(err).__name__,
                               attempts=max(1, job.attempts),
                               quarantined=quarantined)
        _telemetry.trace_end(job.trace_id, status="failed")
        _telemetry.inc("serve_jobs_failed_total", tenant=job.tenant)
        if quarantined:
            _telemetry.inc("serve_jobs_quarantined_total",
                           tenant=job.tenant)

    def _dissolve(self, bank: _Bank, err: BaseException, *, reason: str,
                  charge: bool = True,
                  requeue: Optional[List[Job]] = None) -> None:
        """Failure isolation: tear a faulted bank down WITHOUT failing its
        jobs.  They return to their bucket and re-bucket into fresh banks;
        a retried job re-runs from gate 0 under its own measurement seed,
        so completing under retry equals a fault-free run.
        ``charge=True`` burns one unit of each job's retry budget and
        gates its return behind decorrelated-jitter backoff;
        ``charge=False`` (failover, poison bisection) requeues at once and
        free: the fault was the infrastructure's or a bank-mate's.  Jobs
        past their budget exhaust to FAILED with the per-attempt error
        chain."""
        jobs = requeue if requeue is not None else list(bank.jobs)
        _telemetry.inc("serve_bank_retries_total", reason=reason)
        _telemetry.flight_event("bank_dissolved", bank=bank.seq,
                                reason=reason, jobs=len(jobs),
                                error=f"{type(err).__name__}: {err}")
        now = time.monotonic()
        for job in jobs:
            started = job.t_start is not None
            if charge and job.attempts > self.retries:
                self._fail_job(job, err)  # records its attempt line
                continue
            job.errors.append(
                f"attempt {max(1, job.attempts)}: "
                f"{type(err).__name__}: {err}")
            job.state = QUEUED
            job.error = err
            job.t_start = None
            if charge:
                job.backoff = _resilience.backoff_delay(
                    self._backoff_base, job.backoff)
                job.not_before = now + job.backoff
            if started:
                self._queued += 1
            self._buckets.setdefault(bank.key, []).append(job)
            _telemetry.trace_point(
                job.trace_id, "serve.retry", reason=reason,
                attempt=job.attempts,
                backoff=round(job.backoff or 0.0, 4))
        self._drop_bank(bank)
        _telemetry.set_gauge("serve_queue_depth", self._queued)

    def _quarantine(self, job: Job, bank: _Bank,
                    err: BaseException) -> None:
        """Terminal poison verdict: fail the job and charge its (tenant,
        structure) circuit breaker."""
        key = (job.tenant, bank.key)
        br = self._breakers.get(key)
        if br is None:
            br = self._breakers[key] = _Breaker(self._q_threshold,
                                                self._q_open_seconds)
        br.record_failure()
        _telemetry.trace_point(job.trace_id, "serve.quarantine",
                               breaker=br.state,
                               failures=br.failures)
        self._fail_job(job, err, quarantined=True)
        _telemetry.set_gauge("serve_queue_depth", self._queued)
        self._flight_dump("quarantine", tenant=job.tenant, job=job.id,
                          trace_id=job.trace_id, breaker=br.state,
                          error=f"{type(err).__name__}: {err}")

    def _quarantine_or_bisect(self, bank: _Bank,
                              err: BaseException) -> None:
        """Poison-job containment.  A singleton bank IS the culprit:
        quarantine it.  A bank of several jobs re-runs them in smaller
        cohorts: the watchdog's worst-element attribution sends the
        suspect straight to a singleton (one extra round), an
        unattributed verdict (a repeated allocator failure) halves the
        bank (log2(B) rounds), with bank-mates requeued free of charge,
        so innocents always complete."""
        jobs = list(bank.jobs)
        _telemetry.flight_event(
            "bisect", bank=bank.seq, jobs=len(jobs),
            attributed=getattr(err, "element", None) is not None,
            error=f"{type(err).__name__}: {err}")
        if _governor._is_oom(err):
            self._flight_dump("oom_bisect", bank=bank.seq,
                              jobs=len(jobs))
        if len(jobs) == 1:
            self._quarantine(jobs[0], bank, err)
            self._dissolve(bank, err, reason="poison", charge=False,
                           requeue=[])
            return
        element = getattr(err, "element", None)
        if element is not None and 0 <= int(element) < max(bank.B, 1):
            # element i of the padded batch belongs to job i (padding
            # repeats the LAST job, so clamp)
            culprit = jobs[min(int(element), len(jobs) - 1)]
            culprit.bisect_group = (f"bisect-{bank.seq}-culprit", 1)
            for j in jobs:
                if j is not culprit:
                    j.bisect_group = None
        else:
            half = (len(jobs) + 1) // 2
            cap = 1
            while cap < half:
                cap <<= 1
            for idx, j in enumerate(jobs):
                j.bisect_group = (f"bisect-{bank.seq}-{idx // half}",
                                  cap)
        self._dissolve(bank, err, reason="poison", charge=False)

    def _failover(self, err: BaseException) -> None:
        """Elastic degraded-mode failover: shrink the serving mesh and keep
        EVERY queued and running job.  Running banks with a committed
        generation roll back to it (the elastic restore reshards it onto
        the shrunk mesh at resume); banks without one dissolve free of
        charge and retry.  Queued work is untouched; admission re-prices
        by itself, since _job_bytes_per_device reads the live env.  An
        env of torch.distributed ranks cannot shrink in process:
        shrink_env's QuESTError propagates, the banks and queues left as
        they were."""
        t0 = time.perf_counter()
        old_n = self.env.num_devices
        if old_n <= 1:
            # nowhere left to shrink: treat as transient infrastructure
            for bank in [b for b in self._banks if b.started]:
                self._dissolve(bank, err, reason="failover",
                               charge=False)
            return
        new_n = old_n // 2
        excl = None
        dead_host = None
        topo = getattr(self.env, "topology", None)
        shard = getattr(err, "shard", None)
        if shard is not None and topo is not None and topo.hosts > 1:
            # host-aware exclusion: drop the dead host's whole device
            # range so the survivors are intact hosts (2x4 -> 1x4)
            dead_host = topo.host_of(int(shard))
            excl = list(topo.host_range(dead_host))
            if old_n - len(excl) < new_n:
                excl = excl[:old_n - new_n]
        new_env = shrink_env(self.env, new_n, exclude_indices=excl)
        for bank in [b for b in self._banks if b.started]:
            if bank.preempted:
                continue  # its generation restores elastically on resume
            cursor = _resilience.latest_committed_cursor(bank.ckpt_dir) \
                if bank.ckpt_dir else None
            if cursor is not None and self.preempt == "checkpoint":
                # roll back to the committed generation: resume reloads
                # it onto whatever mesh is then live
                self._release_device(bank)
                bank.cursor = int(cursor)
                bank.preempted = True
                bank.paused = False
                _telemetry.inc("serve_bank_retries_total",
                               reason="failover")
            else:
                self._dissolve(bank, err, reason="failover",
                               charge=False)
        self.env = new_env
        # keep the warm pool one failover ahead: this mesh's specs were
        # queued at bank start; queue the next shrink level
        if self.prewarm:
            with self._prewarm_lock:
                known = list(self._warm_specs.values())
            for spec in known:
                nxt = dict(spec)
                nxt["ndev"] = max(1, new_n // 2)
                self._enqueue_prewarm(nxt)
        _ptopo.notify_mesh_event("serve_failover", from_devices=old_n,
                                 to_devices=new_n, dead_host=dead_host)
        _resilience.record_degradation(
            f"serve_failover_{old_n}to{new_n}",
            f"{err}; serving degraded onto {new_n} devices"
            + (f" (host {dead_host} excluded)"
               if dead_host is not None else ""))
        _telemetry.inc("serve_failovers_total")
        _telemetry.set_gauge("serve_degraded", 1.0)
        _telemetry.set_gauge("serve_failover_mttr_seconds",
                             time.perf_counter() - t0)
        self._flight_dump("failover", from_devices=old_n,
                          to_devices=new_n, dead_host=dead_host,
                          error=f"{type(err).__name__}: {err}")

    def heal(self) -> bool:
        """Re-expand onto the recovered full mesh (the operator's signal
        after the infrastructure came back).  Resident banks drain to
        their current checkpoint boundary (a committed generation on the
        degraded mesh), the serving env swaps back to the full mesh, and
        every bank resumes through the mesh-portable elastic restore:
        checkpoint REGROW.  Later submissions are priced and run on the
        full mesh.  Returns False when not degraded."""
        if self._closed or self.env is self._full_env:
            return False
        t0 = time.perf_counter()
        for bank in [b for b in self._banks if b.started]:
            if bank.qureg is None:
                continue  # already at a checkpoint boundary
            try:
                with _telemetry.span("serve.heal_drain", bank=bank.seq):
                    bank.ex.checkpoint(bank.ckpt_dir)
                bank.cursor = bank.ex.cursor
                self._release_device(bank)
                bank.preempted = True
                bank.paused = False
            except (QuESTError, OSError, TimeoutError) as e:
                # the drain failed: this bank retries from scratch on the
                # healed mesh instead of blocking the heal
                self._dissolve(bank, e, reason="transient",
                               charge=False)
        healed = self._full_env
        # re-derive the topology through the declared spec: healing
        # restores the operator's arrangement (1x4 back to 2x4)
        healed = dataclasses.replace(
            healed, topology=_ptopo.grow(
                getattr(self.env, "topology", None),
                healed.num_devices))
        self.env = self._full_env = healed
        _ptopo.notify_mesh_event("serve_heal",
                                 to_devices=healed.num_devices)
        _telemetry.inc("serve_heals_total")
        _telemetry.set_gauge("serve_degraded", 0.0)
        _telemetry.set_gauge("serve_heal_seconds",
                             time.perf_counter() - t0)
        return True

    def _finalize(self, bank: _Bank) -> None:
        """Drain the finished bank: run the measurement schedule
        (per-element key streams), hand each job its canonical amplitudes
        (on the host), outcomes and final key state, and release the
        register."""
        q = bank.qureg
        for qb in bank.measure:
            outs, probs = _batch.measureBatched(q, qb)
            for i, job in enumerate(bank.jobs):
                job.outcomes.append((int(outs[i]), float(probs[i])))
        amps = _host_bank(q)
        keys = q.key_state()
        now = time.perf_counter()
        for i, job in enumerate(bank.jobs):
            job.amps = amps[i]
            job.key_state = {"key": keys["keys"][i],
                             "counter": keys["counters"][i]}
            job.state = DONE
            job.t_done = now
            job.bisect_group = None
            t = self.tenants[job.tenant]
            t.inflight -= 1
            t.inflight_bytes -= job.bytes
            t.completed += 1
            self.completed += 1
            # a completed probe closes its (tenant, structure) breaker
            br = self._breakers.get((job.tenant, bank.key))
            if br is not None:
                br.record_success()
            _telemetry.trace_point(job.trace_id, "serve.complete",
                                   outcomes=len(job.outcomes),
                                   attempts=job.attempts)
            _telemetry.trace_end(job.trace_id, status="done")
            _telemetry.inc("serve_jobs_completed_total",
                           tenant=job.tenant)
            _telemetry.observe("serve_job_seconds", now - job.t_submit,
                               tenant=job.tenant)
        self._publish_occupancy(bank)
        self._refresh_watermark()
        self._banks.remove(bank)
        self._release_device(bank)
        if bank.ckpt_dir and os.path.isdir(bank.ckpt_dir):
            shutil.rmtree(bank.ckpt_dir, ignore_errors=True)

    def _fail(self, bank: _Bank, err: BaseException) -> None:
        """Terminal bank failure (a memory refusal with nothing left to
        evict): every job exhausts to FAILED, each wrapped per job by
        Job.result's JobFailedError, never a shared raise."""
        _telemetry.flight_event("executor_failure", bank=bank.seq,
                                jobs=len(bank.jobs),
                                error=f"{type(err).__name__}: {err}")
        for job in bank.jobs:
            self._fail_job(job, err)
        self._drop_bank(bank)
        _telemetry.set_gauge("serve_queue_depth", self._queued)
        self._flight_dump("executor_failure", bank=bank.seq,
                          error=f"{type(err).__name__}: {err}")

    # -- observability front door ----------------------------------------

    def _refresh_watermark(self) -> None:
        """Refresh the ``device_memory_watermark_bytes{device}`` gauges at
        a bank boundary (start, finalize) so the memory pressure /metrics
        shows tracks the resident set, not only drains."""
        if not _telemetry.enabled():
            return
        from .utils import profiling as _prof

        _prof.memory_watermark()

    def _flight_dump(self, reason: str, **context):
        """Dump the telemetry flight recorder for one serve incident.
        Best effort: a failed dump is counted (``flight_dump_errors_total``)
        and never raised, since the incident handler it rides on must
        still run.  Returns the written path (also appended to
        :attr:`flight_dumps`) or None."""
        if not _telemetry.enabled():
            return None
        path = os.path.join(
            self._flight_dir,
            f"flight_s{self._serial}_{len(self.flight_dumps)}"
            f"_{reason}.json")
        try:
            out = _telemetry.dump_flight(path, reason=reason,
                                         server=self._serial, **context)
        except OSError:
            _telemetry.inc("flight_dump_errors_total", reason=reason)
            return None
        if out:
            self.flight_dumps.append(out)
        return out

    def tracez(self, job=None) -> Optional[dict]:
        """The reconstructed span tree of one job, the server's view over
        ``telemetry.tracez``.  ``job`` may be a :class:`Job`, a job id
        (mapped through this server's trace-id namespace) or a raw trace
        id; None returns the index of every held trace.  Unknown ids
        return None."""
        if job is None:
            return _telemetry.tracez(None)
        if isinstance(job, Job):
            tid = job.trace_id
        elif isinstance(job, int):
            tid = f"s{self._serial}-j{job}"
        else:
            tid = str(job)
        return _telemetry.tracez(tid)

    # -- warm pool -------------------------------------------------------

    def _warm_variants(self, bank) -> None:
        """Queue this bank's spec for the warm pool: on the live mesh and
        on the half mesh the next failover would shrink onto."""
        if not self.prewarm or bank.qureg is None:
            return
        q = bank.qureg
        ndev = self.env.num_devices
        for nd in dict.fromkeys((ndev, max(1, ndev // 2))):
            self._enqueue_prewarm({
                "v": 1, "items": list(bank.items), "sfp": bank.sfp,
                "n": q.num_qubits_in_state_vec, "batch": bank.B,
                "dtype": str(q.dtype).replace("torch.", ""),
                "ndev": int(nd),
            })

    def _enqueue_prewarm(self, spec: dict) -> bool:
        """Deduplicated enqueue onto the prewarm thread (started lazily:
        a server that never sees prewarm work never owns a thread).
        True when the spec was new."""
        key = (spec.get("sfp"), int(spec["n"]), int(spec["batch"]),
               str(spec["dtype"]), int(spec["ndev"]))
        with self._prewarm_lock:
            if key in self._warm_specs or self._closed:
                return False
            self._warm_specs[key] = spec
            self._prewarm_q.append((key, spec))
            self._prewarm_pending += 1
            _telemetry.set_gauge("serve_prewarm_backlog",
                                 float(self._prewarm_pending))
            if self._prewarm_thread is None:
                self._prewarm_thread = threading.Thread(
                    target=self._prewarm_loop, name="qt-serve-prewarm",
                    daemon=True)
                self._prewarm_thread.start()
            self._prewarm_wake.notify_all()
        return True

    def _prewarm_loop(self) -> None:
        while True:
            with self._prewarm_lock:
                while not self._prewarm_q and not self._closed:
                    self._prewarm_wake.wait(0.1)
                if self._closed:
                    return
                key, spec = self._prewarm_q.pop(0)
            try:
                status = self._prewarm_one(spec)
            # qlint: allow(broad-except): a failed warm-up must never hurt the serving thread; the drain then plans its window itself
            except Exception:
                status = "error"
            with self._prewarm_lock:
                self._prewarm_pending -= 1
                if status in ("compiled", "hit", "present"):
                    self._warm_keys.add(key)
                _telemetry.set_gauge("serve_prewarm_backlog",
                                     float(self._prewarm_pending))
                _telemetry.set_gauge("serve_warm_pool_depth",
                                     float(len(self._warm_keys)))
                self._prewarm_wake.notify_all()
            _telemetry.inc("serve_prewarm_total", status=status)

    def _prewarm_one(self, spec: dict) -> str:
        """Plan one bank spec's windows into the plan tiers ahead of its
        drains, exactly as a WindowExecutor drains them: the same
        checkpoint boundaries, the optimizer suppressed, and on a mesh
        the live permutation carried from window to window; a spec of
        half the live mesh plans on shrink_env's mesh, the one a failover
        restores onto (quest_tpu/serve.py:1452).  Returns ``disabled``
        while QT_AOT_CACHE is unset, else ``compiled`` (a window was
        planned and stored), ``hit`` (loaded from the disk), ``present``
        (every window already in memory), ``skipped`` (no such mesh
        here) or ``empty``."""
        from . import aotcache as _aotcache
        from . import fusion as F
        from . import optimizer as _opt
        from .parallel.mesh import InProcessMesh

        if not _aotcache.enabled():
            return "disabled"
        ndev = int(spec["ndev"])
        env = self.env
        if ndev != env.num_devices:
            if (not isinstance(env.mesh, InProcessMesh) or ndev < 1
                    or env.num_devices % ndev):
                return "skipped"
            env = shrink_env(env, ndev)
        stub = _PlanStub(env, int(spec["n"]), int(spec["batch"]),
                         spec["dtype"])
        items = list(spec["items"])
        identity = list(range(stub.num_qubits_in_state_vec))
        statuses = set()
        cursor = 0
        with _opt.suppressed():
            for end in C.plan_checkpoint_boundaries(len(items),
                                                    self.window):
                status, final_perm = F.aot_prewarm(stub, items[cursor:end])
                cursor = end
                if status in ("empty", "uncacheable"):
                    continue
                statuses.add(status)
                if stub.is_sharded and final_perm is not None \
                        and list(final_perm) != identity:
                    stub._perm = tuple(final_perm)
                else:
                    stub._perm = None
        if not statuses:
            return "empty"
        for s in ("compiled", "hit", "present"):
            if s in statuses:
                return s
        return statuses.pop()

    def prewarm_join(self, timeout: float = 60.0) -> bool:
        """Block until the prewarm queue drains (replica boot, tests).
        False on timeout."""
        deadline = time.perf_counter() + float(timeout)
        with self._prewarm_lock:
            while self._prewarm_pending > 0:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._prewarm_wake.wait(min(left, 0.1))
        return True

    def export_warmset(self) -> List[dict]:
        """The observed hot fingerprint set as picklable specs, for a
        fresh replica's :meth:`warm_from`."""
        with self._prewarm_lock:
            return [dict(s) for s in self._warm_specs.values()]

    def warm_from(self, warmset: Sequence[dict]) -> int:
        """Adopt another replica's exported warm set: every spec is
        queued against THIS server's mesh family (a spec from a bigger
        mesh warms the live size instead).  Returns the number of new
        specs queued."""
        count = 0
        for spec in warmset:
            spec = dict(spec)
            if int(spec.get("ndev", 0)) > self.env.num_devices \
                    or int(spec.get("ndev", 0)) < 1:
                spec["ndev"] = self.env.num_devices
            if self._enqueue_prewarm(spec):
                count += 1
        return count

    def _healthz(self) -> dict:
        """The health snapshot behind ``/healthz``.  stats() iterates
        live dicts the scheduling thread mutates; a concurrent resize
        raises RuntimeError, so the HTTP thread retries the snapshot
        instead of locking the scheduling path."""
        for _ in range(8):
            try:
                s = self.stats()
                break
            except RuntimeError:
                continue
        else:
            s = {"queued": self._queued, "completed": self.completed}
        degraded = bool(s.get("degraded"))
        breakers = int(s.get("open_breakers", 0))
        return {
            "status": "degraded" if degraded or breakers else "ok",
            "degraded": degraded,
            "devices": int(s.get("devices", self.env.num_devices)),
            "queue_depth": int(s.get("queued", 0)),
            "waiting_unbanked": int(s.get("waiting_unbanked", 0)),
            "banks": int(s.get("banks", 0)),
            "preempted_banks": int(s.get("preempted_banks", 0)),
            "completed": int(s.get("completed", 0)),
            "open_breakers": breakers,
            "flight_dumps": len(self.flight_dumps),
            "warm_pool_depth": len(self._warm_keys),
            "prewarm_backlog": int(self._prewarm_pending),
        }

    def serve_http(self, host: str = "127.0.0.1",
                   port: int = 0) -> Tuple[str, int]:
        """Start the observability endpoint on a daemon thread and return
        its bound ``(host, port)`` (``port=0`` picks a free one):

        - ``GET /metrics``: the Prometheus exposition, byte for byte
          ``telemetry.prometheus_text()``;
        - ``GET /healthz``: JSON health: the degraded flag, queue depth,
          open quarantine breakers (status not "ok" when either);
        - ``GET /tracez``: the JSON index of held request traces;
          ``/tracez/<trace_id>`` (or ``?id=``) one reconstructed span
          tree (404 for unknown ids).

        Idempotent: a second call returns the existing address.  The
        thread stops with :meth:`close`."""
        from http.server import (BaseHTTPRequestHandler,
                                 ThreadingHTTPServer)

        if self._http is not None:
            return self._http.server_address
        server = self

        class _ObsHandler(BaseHTTPRequestHandler):
            def log_message(self, *_args):  # no stderr chatter
                pass

            def _send(self, code: int, body: str, ctype: str) -> None:
                data = body.encode("utf-8")
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)

            def _json(self, code: int, doc: dict) -> None:
                self._send(code, json.dumps(doc, sort_keys=True),
                           "application/json")

            def do_GET(self) -> None:
                path, _, query = self.path.partition("?")
                if path == "/metrics":
                    self._send(
                        200, _telemetry.prometheus_text(),
                        "text/plain; version=0.0.4; charset=utf-8")
                elif path == "/healthz":
                    self._json(200, server._healthz())
                elif path == "/tracez" or path.startswith("/tracez/"):
                    tid = path[len("/tracez/"):]
                    if not tid and query.startswith("id="):
                        tid = query[len("id="):]
                    doc = server.tracez(tid or None)
                    if doc is None:
                        self._json(404, {"error":
                                         f"unknown trace id {tid!r}"})
                    else:
                        self._json(200, doc)
                else:
                    self._json(404, {
                        "error": f"no route {path!r}",
                        "endpoints": ["/metrics", "/healthz",
                                      "/tracez"]})

        self._http = ThreadingHTTPServer((host, int(port)), _ObsHandler)
        self._http.daemon_threads = True
        self._http_thread = threading.Thread(
            target=self._http.serve_forever, name="qt-serve-obs",
            daemon=True)
        self._http_thread.start()
        return self._http.server_address

    # -- drivers ---------------------------------------------------------

    def run_until_idle(self, max_steps: Optional[int] = None) -> int:
        """Step until nothing is runnable; returns the number of steps
        taken.  ``max_steps`` bounds runaway loops in tests."""
        steps = 0
        while self.step():
            steps += 1
            if max_steps is not None and steps >= max_steps:
                break
        return steps

    def stats(self) -> dict:
        """Live queue and occupancy snapshot (reportPerf's serving
        section reads the telemetry counters; this is the programmatic
        view)."""
        waiting = sum(len(v) for v in self._buckets.values())
        return {
            "queued": self._queued,
            "waiting_unbanked": waiting,
            "banks": len(self._banks),
            "preempted_banks": sum(1 for b in self._banks
                                   if b.preempted or b.paused),
            "completed": self.completed,
            "degraded": self.env is not self._full_env,
            "devices": self.env.num_devices,
            "open_breakers": sum(1 for br in self._breakers.values()
                                 if br.state != "closed"),
            "tenants": {
                name: {"weight": t.weight, "vtime": t.vtime,
                       "inflight": t.inflight,
                       "inflight_bytes": t.inflight_bytes,
                       "submitted": t.submitted,
                       "completed": t.completed}
                for name, t in self.tenants.items()},
        }

    def close(self) -> None:
        """Release every bank's device memory and governor entry and
        (when the server created it) the preemption checkpoint root."""
        if self._closed:
            return
        self._closed = True
        t = self._prewarm_thread
        if t is not None:
            with self._prewarm_lock:
                self._prewarm_wake.notify_all()
            t.join(timeout=5.0)
            self._prewarm_thread = None
        if self._http is not None:
            self._http.shutdown()
            self._http.server_close()
            self._http = None
            self._http_thread = None
        _ptopo.remove_mesh_listener(self._mesh_cb)
        for bank in self._banks:
            self._release_device(bank)
        self._banks.clear()
        self._buckets.clear()
        if self._own_ckpt_root:
            shutil.rmtree(self._ckpt_root, ignore_errors=True)

    def __enter__(self) -> "SimServer":
        return self

    def __exit__(self, *_exc) -> None:
        self.close()


class Service:
    """Asyncio front end over a :class:`SimServer`: a cooperative stepping
    loop plus awaitable submission.  One event loop and no threads: the
    scheduling core stays synchronous and deterministic, and the service
    yields to the loop between fusion windows (the safe points the
    WindowExecutor guarantees).

    Usage::

        server = SimServer(env)
        async with Service(server) as svc:
            job = await svc.submit(gates, num_qubits=8,
                                   tenant="alice",
                                   priority="interactive")
            amps = (await svc.wait(job)).amps
    """

    def __init__(self, server: SimServer, *, idle_sleep: float = 0.001):
        self.server = server
        self.idle_sleep = float(idle_sleep)
        self._task: Optional[asyncio.Task] = None
        self._stopping = False

    async def submit(self, gates, **kwargs) -> Job:
        """Admit one job (QuotaExceededError propagates to the caller:
        the await point IS the backpressure)."""
        return self.server.submit(gates, **kwargs)

    async def wait(self, job: Job) -> Job:
        """Await a job's completion; a failure re-raises as the same fresh
        per-job :class:`JobFailedError` Job.result raises."""
        while not job.done:
            await asyncio.sleep(0)
        if job.state == FAILED:
            raise job._failure() from job.error
        return job

    async def submit_and_wait(self, gates, **kwargs) -> Job:
        return await self.wait(await self.submit(gates, **kwargs))

    async def _run(self) -> None:
        while not self._stopping:
            progressed = self.server.step()
            # yield between windows so submissions and awaits interleave
            # with execution: the continuous half of the batcher
            await asyncio.sleep(0 if progressed else self.idle_sleep)

    def start(self) -> None:
        if self._task is None or self._task.done():
            self._stopping = False
            self._task = asyncio.get_running_loop().create_task(
                self._run())

    async def aclose(self) -> None:
        self._stopping = True
        if self._task is not None:
            await self._task
            self._task = None

    async def __aenter__(self) -> "Service":
        self.start()
        return self

    async def __aexit__(self, *_exc) -> None:
        await self.aclose()
