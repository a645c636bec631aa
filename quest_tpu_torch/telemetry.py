"""Telemetry: the metrics registry, spans and the perf report.

The port of the JAX package's ``telemetry.py``: one process-wide
registry every layer reports into.

* **Metrics**: counters, gauges and histograms with labelled series
  (``inc`` / ``inc_key`` / ``set_gauge`` / ``observe``).  The hot layers
  record the JAX package's series at the same sites with the same
  labels: api dispatch (``dispatch_total{family}``), the fusion drain
  (``fusion_drains_total``, ``fusion_windows_total``, plan-cache hits
  and misses, window-size histograms, ``plan_route_seconds{route}``),
  the exchange layer (``exchanges_total{op,chunks,tier}``,
  ``exchange_bytes_total{op,tier}``: per-shard bytes), measurement
  (``measurement_shots_total``) and the resilience layer
  (``checkpoint_commit_seconds``, ``watchdog_verdicts_total``,
  ``failovers_total``).  The degradation registry (resilience.py) is
  folded in at read time as ``degradation_active{name}`` gauges.

* **Spans**: ``with telemetry.span("fusion.drain") as sp:`` observes
  the duration into ``span_seconds{name}``, appends a record (name,
  start and end in ns, its id, the id of the span open on the same
  thread when it began, its attrs) to the bounded span ring in both
  enabled modes, and opens ``torch.profiler.record_function(name)``, so
  the region lands inside a ``torch.profiler`` trace around the kernels
  it encloses, and, where CUDA is available, an NVTX range.
  ``spans()`` reads the ring; ``write_trace`` writes it as Chrome JSON.

* **One clock**: every timestamp recorded here (spans, request traces,
  the flight ring) is ``now_ns()``, Unix-epoch nanoseconds: the clock
  ``torch.profiler`` stamps its events with, so a span's record lies
  over the profiler's range of the same span and over the kernels the
  trace shows beside it.

* **Export**: ``snapshot()``, ``prometheus_text()``, ``write_trace()``
  and ``report_perf(env)`` / ``reportPerf``.

* **Request traces** (``trace_begin`` / ``trace_point`` / ``trace_end``,
  ``tracez``) and the **flight recorder** (``flight_event`` /
  ``dump_flight``), bounded rings as in the JAX package.

Gating: ``QT_TELEMETRY=off|on|trace`` (default on).  Every recording
entry point starts with one module-global int test, so the off path is
a no-op check; registry upserts take one ``threading.Lock``, acquired
only on the enabled path.  In trace mode the drain also synchronises the
card after each program group, so ``plan_route_seconds`` holds device
time; in on mode it times the host dispatch only.
"""

from __future__ import annotations

import atexit
import bisect
import collections
import contextlib
import itertools
import json
import math
import os
import threading
import time
from typing import Iterator, Optional

OFF, ON, TRACE = 0, 1, 2
_MODES = {"off": OFF, "on": ON, "trace": TRACE, "0": OFF, "1": ON}
_MODE_NAMES = {OFF: "off", ON: "on", TRACE: "trace"}

_ENV_VAR = "QT_TELEMETRY"
_TRACE_DIR_ENV = "QT_TELEMETRY_TRACE_DIR"
_TRACE_MAX_ENV = "QT_TELEMETRY_TRACE_MAX"
_FLIGHT_MAX_ENV = "QT_FLIGHT_EVENTS"
_FLIGHT_DIR_ENV = "QT_FLIGHT_DIR"
_TRACEZ_IDS_ENV = "QT_TRACEZ_JOBS"
_TRACEZ_EVENTS_ENV = "QT_TRACEZ_EVENTS"


def _env_cap(var: str, default: int) -> int:
    raw = os.environ.get(var, "").strip()
    return max(1, int(raw)) if raw else default


# registry state: key = (metric name, canonical label tuple).  One lock
# guards every upsert: the serve layer writes from asyncio + HTTP +
# executor threads, and counters must be exact across them.  The lock is
# taken only on the enabled path (after the _mode test), so the off path
# stays a single int check.
_LOCK = threading.Lock()
_COUNTERS: dict = {}
_GAUGES: dict = {}
_HISTS: dict = {}
# the span ring: a BOUNDED deque of span records (a long serve session
# must not grow without bound) — overflow drops the OLDEST record,
# counts trace_events_dropped_total, and write_trace notes the drop in
# the emitted JSON.  A record is the tuple (name, start_ns, end_ns, id,
# parent id, thread id, attrs); spans() hands them out as dicts.
_TRACE_MAX = _env_cap(_TRACE_MAX_ENV, 65536)
_TRACE_EVENTS: collections.deque = collections.deque()
_TRACE_DROPPED = [0]  # drops since the last write_trace
_SPAN_IDS = itertools.count(1)
# per thread: the ids of the spans open on it, innermost last
_OPEN = threading.local()
# flight recorder: bounded ring of recent structured events (spans,
# degradations, watchdog verdicts, drift, admission decisions) dumped
# as a JSON post-mortem on serve/resilience incidents
_FLIGHT_MAX = _env_cap(_FLIGHT_MAX_ENV, 512)
_FLIGHT: collections.deque = collections.deque(maxlen=_FLIGHT_MAX)
_FLIGHT_SEQ = [0]
# request-scoped trace store: trace_id -> {"events", "stack", "dropped"}
# (bounded: oldest id evicted past _TRACEZ_IDS, per-id events capped)
_TRACEZ_IDS = _env_cap(_TRACEZ_IDS_ENV, 256)
_TRACEZ_EVENTS = _env_cap(_TRACEZ_EVENTS_ENV, 512)
_JOB_TRACES: dict = {}


def _resolve_mode() -> int:
    raw = os.environ.get(_ENV_VAR, "on").strip().lower()
    return _MODES.get(raw, ON)


_mode = _resolve_mode()


def now_ns() -> int:
    """The telemetry's clock: Unix-epoch nanoseconds (``time.time_ns``),
    the clock ``torch.profiler`` stamps its host and device events
    with."""
    # qlint: allow(nondeterminism): a telemetry timestamp IS the recorded value (spans, traces, the flight ring), never program state
    return time.time_ns()


def configure(mode: Optional[str] = None) -> str:
    """Set the telemetry mode ("off" / "on" / "trace"), or re-resolve it
    from ``QT_TELEMETRY`` when called with no argument.  Returns the
    active mode name.  Recorded series survive mode flips (reset()
    clears them)."""
    global _mode
    if mode is None:
        _mode = _resolve_mode()
    else:
        key = str(mode).strip().lower()
        if key not in _MODES:
            raise ValueError(
                f"telemetry.configure: unknown mode {mode!r} "
                f"(expected off/on/trace)")
        _mode = _MODES[key]
    return _MODE_NAMES[_mode]


def mode_name() -> str:
    return _MODE_NAMES[_mode]


def enabled() -> bool:
    return _mode != OFF


def reset() -> None:
    """Clear every recorded series, buffered trace event, flight-ring
    entry, and request trace (tests and benchmark harnesses; the mode is
    left unchanged)."""
    with _LOCK:
        _COUNTERS.clear()
        _GAUGES.clear()
        _HISTS.clear()
        _TRACE_EVENTS.clear()
        _TRACE_DROPPED[0] = 0
        _FLIGHT.clear()
        _JOB_TRACES.clear()


# ---------------------------------------------------------------------------
# Recording
# ---------------------------------------------------------------------------


def _label_key(labels: dict) -> tuple:
    if not labels:
        return ()
    return tuple(sorted((k, v if type(v) is str else str(v))
                        for k, v in labels.items()))


def inc(name: str, value: float = 1, /, **labels) -> None:
    """Add ``value`` to the counter series ``name{labels}`` (exact under
    concurrent writers — the upsert holds the registry lock)."""
    if not _mode:
        return
    key = (name, _label_key(labels))
    with _LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0) + value


def counter_key(name: str, /, **labels) -> tuple:
    """Precomputed series key for :func:`inc_key` — per-gate dispatch
    sites build their label tuple ONCE at import time so the hot-loop
    cost is a single dict upsert."""
    return (name, _label_key(labels))


def inc_key(key: tuple, value: float = 1) -> None:
    """inc() over a key from :func:`counter_key` (the dispatch fast
    path)."""
    if not _mode:
        return
    with _LOCK:
        _COUNTERS[key] = _COUNTERS.get(key, 0) + value


def set_gauge(name: str, value: float, /, **labels) -> None:
    """Set the gauge series ``name{labels}`` to ``value``."""
    if not _mode:
        return
    with _LOCK:
        _GAUGES[(name, _label_key(labels))] = float(value)


# histogram bucket upper bounds, per metric name; the default suits
# second-valued latencies, the explicit entries are size-valued
_DEFAULT_BOUNDS = (1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 60.0)
HIST_BOUNDS = {
    # guarded-collective dispatch latency (dist.guarded_dispatch): finer
    # low end than the default — a healthy CPU/ICI exchange dispatch sits
    # in the 10us-10ms decades and the deadline policy needs resolution
    # there
    "exchange_latency_seconds": (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0,
                                 60.0),
    "fusion_drain_gates": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    "fusion_window_gates": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    "fusion_remap_window_items": (1, 2, 4, 8, 16, 32, 64, 128, 256, 512,
                                  1024),
    # circuit-optimizer rewrite time (optimizer.optimize_items): pure
    # host work that should sit well under a drain's planning cost, so
    # the low decades get extra resolution
    "optimizer_seconds": (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0, 60.0),
    # serving-layer queue wait (serve.SimServer): interactive jobs on a
    # loaded server should sit in the sub-ms..100ms decades, so the low
    # end gets the same extra resolution as exchange latency
    "serve_queue_wait_seconds": (1e-5, 1e-4, 1e-3, 1e-2, 1e-1, 1.0, 10.0,
                                 60.0),
    # first dispatch through a freshly-traced executor (§31 AOT cache,
    # labeled fingerprint_cached=true/false): cached first requests sit
    # near steady-state (ms..100ms), uncached ones in the compile
    # decades (seconds..minutes) — both ends need resolution
    "first_request_seconds": (1e-3, 1e-2, 1e-1, 0.5, 1.0, 5.0, 15.0,
                              60.0, 300.0),
}


class _Hist:
    __slots__ = ("count", "total", "vmin", "vmax", "bounds", "buckets")

    def __init__(self, bounds):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.bounds = tuple(bounds)
        self.buckets = [0] * (len(self.bounds) + 1)

    def add(self, v: float) -> None:
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        self.buckets[bisect.bisect_left(self.bounds, v)] += 1

    def as_dict(self) -> dict:
        cum = 0
        buckets = {}
        for bound, n in zip(self.bounds, self.buckets):
            cum += n
            buckets[repr(float(bound))] = cum
        buckets["+Inf"] = self.count
        return {
            "count": self.count,
            "sum": self.total,
            "min": self.vmin if self.count else None,
            "max": self.vmax if self.count else None,
            "buckets": buckets,
        }


def observe(name: str, value: float, /, **labels) -> None:
    """Record one observation into the histogram series ``name{labels}``."""
    if not _mode:
        return
    key = (name, _label_key(labels))
    with _LOCK:
        h = _HISTS.get(key)
        if h is None:
            h = _HISTS[key] = _Hist(HIST_BOUNDS.get(name, _DEFAULT_BOUNDS))
        h.add(float(value))


def record_exchange(op: str, count: int = 1, nbytes: int = 0, *,
                    chunks="auto", tier: str = "ici") -> None:
    """One call per dispatched exchange program AND per interconnect
    tier: ``count`` collective transfers moving ``nbytes`` PER-SHARD
    bytes total over ``tier`` ("ici" intra-host / "dcn" cross-host —
    parallel/topology.py; the byte unit matches
    circuit.remap_exchange_bytes), labeled with the op family and the
    resolved chunk configuration.  A mixed-tier program (e.g. a window
    remap whose transpositions straddle the host boundary) records once
    per tier with the exact per-tier split, so summing the tier series
    reproduces the flat totals (pinned in tests/test_telemetry.py).  A
    zero ``count`` still records bytes — byte-only attributions (the
    all-gather's cross-host share) keep the count on one tier."""
    if not _mode:
        return
    if count:
        inc("exchanges_total", count, op=op, chunks=chunks, tier=tier)
    if nbytes:
        inc("exchange_bytes_total", nbytes, op=op, tier=tier)


# ---------------------------------------------------------------------------
# Span tracing
# ---------------------------------------------------------------------------


def _ring_append(rec: tuple) -> None:
    # caller holds _LOCK; overflow drops the OLDEST record and counts
    # trace_events_dropped_total
    if len(_TRACE_EVENTS) >= _TRACE_MAX:
        _TRACE_EVENTS.popleft()
        _TRACE_DROPPED[0] += 1
        key = ("trace_events_dropped_total", ())
        _COUNTERS[key] = _COUNTERS.get(key, 0) + 1
    _TRACE_EVENTS.append(rec)


def _open_spans() -> list:
    stack = getattr(_OPEN, "ids", None)
    if stack is None:
        stack = _OPEN.ids = []
    return stack


def current_span() -> Optional[int]:
    """The id of the innermost span open on this thread (None when none
    is, or telemetry is off)."""
    if not _mode:
        return None
    stack = _open_spans()
    return stack[-1] if stack else None


class Span:
    """A span: the context manager ``span()`` returns, and what it yields.
    The body reads its record's ``id`` and ``start_ns`` (0 when telemetry
    is off) and may add to its ``attrs`` until it closes.  A class rather
    than a generator: every drain and QFT opens several."""

    __slots__ = ("name", "attrs", "id", "start_ns", "_parent", "_range")

    def __init__(self, name: str, attrs: dict):
        self.name = name
        self.attrs = attrs
        self.id = self.start_ns = 0

    def __enter__(self) -> "Span":
        if not _mode:
            return self
        self.id = next(_SPAN_IDS)
        stack = _open_spans()
        self._parent = stack[-1] if stack else None
        stack.append(self.id)
        self.start_ns = now_ns()
        self._range = _Range(self.name).__enter__()
        return self

    def __exit__(self, *exc) -> bool:
        if not self.id:
            return False
        try:
            self._range.__exit__(*exc)
        finally:
            t1 = now_ns()
            _open_spans().pop()
            observe("span_seconds", (t1 - self.start_ns) * 1e-9,
                    name=self.name)
            with _LOCK:
                _ring_append((self.name, self.start_ns, t1, self.id,
                              self._parent, threading.get_ident(),
                              self.attrs))
        return False


def span(name: str, **attrs) -> Span:
    """Host-side named region: observes ``span_seconds{name}``, appends
    its record to the span ring (both enabled modes), and opens
    ``torch.profiler.record_function(name)`` (and an NVTX range where
    CUDA is available) so the region also appears inside a
    ``torch.profiler`` / Nsight trace.  ``with span(...) as sp`` yields
    the :class:`Span`.  Records nothing when telemetry is off."""
    return Span(name, attrs)


def record_span(name: str, start_ns: int, end_ns: int,
                parent: Optional[int] = None, **attrs) -> int:
    """Append a span timed elsewhere (``start_ns`` / ``end_ns`` on
    ``now_ns()``'s clock) to the span ring only: no profiler range, no
    histogram; for a region that opens in one call and closes in another
    (the fusion buffer's capture).  Returns its id (0 when off)."""
    if not _mode:
        return 0
    sid = next(_SPAN_IDS)
    with _LOCK:
        _ring_append((name, int(start_ns), int(end_ns), sid, parent,
                      threading.get_ident(), attrs))
    return sid


def spans(since_ns: int = 0) -> list:
    """The span ring's records that started at or after ``since_ns``,
    oldest first by close, as dicts ``{"name", "start_ns", "end_ns",
    "id", "parent", "tid", "attrs"}``.  Empty when telemetry records
    nothing."""
    with _LOCK:
        recs = list(_TRACE_EVENTS)
    return [{"name": r[0], "start_ns": r[1], "end_ns": r[2], "id": r[3],
             "parent": r[4], "tid": r[5], "attrs": dict(r[6])}
            for r in recs if r[1] >= since_ns]


def _chrome_event(rec: tuple) -> dict:
    name, t0, t1, _sid, _parent, tid, attrs = rec
    return {
        "name": name,
        "cat": "quest_tpu_torch",
        "ph": "X",
        "ts": t0 / 1e3,
        "dur": (t1 - t0) / 1e3,
        "pid": os.getpid(),
        "tid": tid,
        "args": {k: str(v) for k, v in attrs.items()},
    }


class _Range:
    """``torch.profiler.record_function(name)`` while a profiler is
    recording (it records the range then and nothing otherwise, and is
    most of a span's cost) plus, where CUDA is available, an NVTX range
    of the same name (a failing NVTX call raises)."""

    __slots__ = ("name", "_rf", "_nvtx")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Range":
        import torch

        self._rf = None
        if torch.autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._nvtx = torch.cuda.is_available()
        if self._nvtx:
            torch.cuda.nvtx.range_push(self.name)
        return self

    def __exit__(self, *exc) -> bool:
        try:
            if self._nvtx:
                import torch

                torch.cuda.nvtx.range_pop()
        finally:
            if self._rf is not None:
                self._rf.__exit__(*exc)
        return False


def annotate(name: str) -> _Range:
    """``with annotate(name):`` a ``torch.profiler.record_function``
    range plus, where CUDA is available, an NVTX range.  Records nothing
    in the registry."""
    return _Range(name)


def write_trace(path: Optional[str] = None) -> Optional[str]:
    """Write the span ring as Chrome trace-event JSON (loadable in
    Perfetto / chrome://tracing; ``ts`` in Unix-epoch microseconds) and
    clear it.  Returns the file
    path, or None (writing nothing) when no events are buffered — so
    ``QT_TELEMETRY=off`` never creates trace files.  Default path:
    ``$QT_TELEMETRY_TRACE_DIR/qt_trace_<pid>.json`` (cwd when the env
    var is unset).  When the bounded ring overflowed since the last
    write, the emitted JSON notes the drop count under
    ``otherData.trace_events_dropped``."""
    if not _TRACE_EVENTS:
        return None
    if path is None:
        d = os.environ.get(_TRACE_DIR_ENV, ".")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"qt_trace_{os.getpid()}.json")
    with _LOCK:
        events = list(_TRACE_EVENTS)
        _TRACE_EVENTS.clear()
        dropped, _TRACE_DROPPED[0] = _TRACE_DROPPED[0], 0
    doc = {"traceEvents": [_chrome_event(r) for r in events],
           "displayTimeUnit": "ms"}
    if dropped:
        doc["otherData"] = {"trace_events_dropped": dropped}
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


@atexit.register
def _flush_trace_at_exit() -> None:  # pragma: no cover - process teardown
    if _mode == TRACE and _TRACE_EVENTS and os.environ.get(_TRACE_DIR_ENV):
        try:
            write_trace()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# Flight recorder (docs/design.md §30)
# ---------------------------------------------------------------------------


def _jsonable(v):
    return v if isinstance(v, (int, float, str, bool)) or v is None \
        else str(v)


def flight_event(kind: str, /, **fields) -> None:
    """Append one structured event to the bounded flight ring — the
    post-mortem record :func:`dump_flight` writes on incidents.  Feeds:
    serve lifecycle/admission events, degradations, watchdog verdicts,
    model drift, and mirrored request-trace spans.  Non-primitive field
    values are stringified so the ring is always JSON-serializable.
    ``kind`` is positional-only; the reserved ``ts``/``kind`` keys win
    over same-named fields."""
    if not _mode:
        return
    ev = {"ts": round(now_ns() * 1e-9, 6), "kind": kind}
    for k, v in fields.items():
        if k not in ("ts", "kind"):
            ev[k] = _jsonable(v)
    with _LOCK:
        _FLIGHT.append(ev)


def flight_snapshot() -> list:
    """The flight ring's current contents, oldest first (a copy)."""
    with _LOCK:
        return list(_FLIGHT)


def dump_flight(path: Optional[str] = None, *, reason: str = "manual",
                **context) -> Optional[str]:
    """Write the flight ring as a JSON post-mortem artifact:
    ``{"reason", "ts", "context", "events"}``.  The ring is NOT drained
    — each dump is a self-contained snapshot, and a later incident still
    sees the earlier context.  Returns the path, or None when telemetry
    is off (incident hooks fire unconditionally; the off mode must stay
    artifact-free).  Default path:
    ``$QT_FLIGHT_DIR/qt_flight_<pid>_<seq>.json`` (cwd when unset)."""
    if not _mode:
        return None
    if path is None:
        d = os.environ.get(_FLIGHT_DIR_ENV, ".")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(
            d, f"qt_flight_{os.getpid()}_{_FLIGHT_SEQ[0]}.json")
    else:
        parent = os.path.dirname(path)
        if parent:
            os.makedirs(parent, exist_ok=True)
    _FLIGHT_SEQ[0] += 1
    doc = {
        "reason": reason,
        "ts": time.time(),  # qlint: allow(nondeterminism): the dump's wall-clock stamp IS the recorded value — a post-mortem artifact label, never program state
        "context": {k: _jsonable(v) for k, v in context.items()},
        "events": flight_snapshot(),
    }
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True)
    inc("flight_dumps_total", reason=reason)
    return path


# ---------------------------------------------------------------------------
# Request-scoped tracing (docs/design.md §30)
# ---------------------------------------------------------------------------


def _trace_rec(tid: str) -> dict:
    # caller holds _LOCK
    rec = _JOB_TRACES.get(tid)
    if rec is None:
        while len(_JOB_TRACES) >= _TRACEZ_IDS:
            _JOB_TRACES.pop(next(iter(_JOB_TRACES)))
        rec = _JOB_TRACES[tid] = {"events": [], "stack": [], "dropped": 0}
    return rec


def _trace_emit(tid: str, ev: dict) -> None:
    # caller holds _LOCK; per-id event cap drops the OLDEST event
    rec = _trace_rec(tid)
    if len(rec["events"]) >= _TRACEZ_EVENTS:
        rec["events"].pop(0)
        rec["dropped"] += 1
    rec["events"].append(ev)


def _us(t_ns: int) -> float:
    return round(t_ns / 1e3, 1)


def trace_begin(tid: str, name: str, **attrs) -> None:
    """Open a span on the request trace ``tid`` (closed by
    :func:`trace_end`; the serve layer opens one root ``"job"`` span per
    submitted job).  Active in both enabled modes."""
    if not _mode:
        return
    with _LOCK:
        rec = _trace_rec(tid)
        rec["stack"].append(
            (name, now_ns(),
             {k: str(v) for k, v in attrs.items()}))


def trace_end(tid: str, **attrs) -> None:
    """Close the innermost open span of ``tid``, recording it as a
    complete event spanning its whole open interval; ``attrs`` merge
    into the span args (e.g. ``status="done"``).  No-op when nothing is
    open."""
    if not _mode:
        return
    now = now_ns()
    with _LOCK:
        rec = _JOB_TRACES.get(tid)
        if rec is None or not rec["stack"]:
            return
        name, t0, args = rec["stack"].pop()
        args.update({k: str(v) for k, v in attrs.items()})
        ev = {"name": name, "ph": "X", "ts": _us(t0),
              "dur": round((now - t0) / 1e3, 1),
              "depth": len(rec["stack"]), "args": args}
        _trace_emit(tid, ev)
        _FLIGHT.append({"ts": round(now * 1e-9, 6), "kind": "span",
                        "trace": tid, "name": name, **args})
        if _mode == TRACE:
            _ring_append((name, t0, now, next(_SPAN_IDS), None,
                          threading.get_ident(), {**args, "trace_id": tid}))


def trace_point(tid: str, name: str, **attrs) -> None:
    """Record one instantaneous lifecycle event on ``tid`` (admit,
    bank_join, retry, quarantine, complete, ...), mirrored into the
    flight ring."""
    if not _mode:
        return
    now = now_ns()
    args = {k: str(v) for k, v in attrs.items()}
    with _LOCK:
        rec = _trace_rec(tid)
        _trace_emit(tid, {"name": name, "ph": "i", "ts": _us(now),
                          "depth": len(rec["stack"]), "args": args})
        _FLIGHT.append({"ts": round(now * 1e-9, 6), "kind": "event",
                        "trace": tid, "name": name, **args})


def trace_add(tid: str, name: str, *, t0: float, dur: float,
              **attrs) -> None:
    """Attach an externally-timed complete span to ``tid`` — e.g. one
    bank window's measured wall time mirrored onto every member job's
    trace.  ``t0`` is its start as a ``time.perf_counter()`` reading,
    ``dur`` its seconds; it is recorded on ``now_ns()``'s clock."""
    if not _mode:
        return
    start = now_ns() - round((time.perf_counter() - t0) * 1e9)
    args = {k: str(v) for k, v in attrs.items()}
    with _LOCK:
        rec = _trace_rec(tid)
        _trace_emit(tid, {"name": name, "ph": "X", "ts": _us(start),
                          "dur": round(dur * 1e6, 1),
                          "depth": len(rec["stack"]), "args": args})
        if _mode == TRACE:
            _ring_append((name, start, start + round(dur * 1e9),
                          next(_SPAN_IDS), None, threading.get_ident(),
                          {**args, "trace_id": tid}))


@contextlib.contextmanager
def trace_span(tid: str, name: str, **attrs) -> Iterator[None]:
    """Context-manager sugar over trace_begin/trace_end."""
    trace_begin(tid, name, **attrs)
    try:
        yield
    finally:
        trace_end(tid)


def _trace_tree(events: list) -> list:
    """Nest a trace's events by (ts, depth) containment: a depth-d event
    is a child of the most recent still-open depth<(d) span."""
    roots: list = []
    stack: list = []  # (depth, node)
    order = sorted(events, key=lambda e: (e["ts"], -e.get("dur", 0.0)))
    for ev in order:
        node = {"name": ev["name"], "ph": ev["ph"], "ts": ev["ts"],
                "args": ev.get("args", {}), "children": []}
        if "dur" in ev:
            node["dur"] = ev["dur"]
        d = ev.get("depth", 0)
        while stack and stack[-1][0] >= d:
            stack.pop()
        (stack[-1][1]["children"] if stack else roots).append(node)
        if ev["ph"] == "X":
            stack.append((d, node))
    return roots


def trace_ids() -> list:
    """Currently-held request trace ids, oldest first."""
    with _LOCK:
        return list(_JOB_TRACES)


def tracez(tid: Optional[str] = None):
    """The request-trace query API (served at ``/tracez``).  With no
    argument: an index ``{"traces": {tid: {events, open, complete}}}``.
    With a ``tid``: that trace's full record — flat ``events`` (ts/dur
    in microseconds, ts on ``now_ns()``'s clock), the nested
    ``tree``, still-``open`` span names, and ``complete`` (True when
    every span closed and at least one event was recorded).  Returns
    None for an unknown id."""
    with _LOCK:
        if tid is None:
            return {"traces": {
                t: {"events": len(r["events"]),
                    "open": [s[0] for s in r["stack"]],
                    "complete": not r["stack"] and bool(r["events"])}
                for t, r in _JOB_TRACES.items()}}
        rec = _JOB_TRACES.get(tid)
        if rec is None:
            return None
        events = [dict(e) for e in rec["events"]]
        open_spans = [{"name": s[0], "ts": _us(s[1]), "args": dict(s[2])}
                      for s in rec["stack"]]
        dropped = rec["dropped"]
    return {
        "trace_id": tid,
        "events": sorted(events, key=lambda e: e["ts"]),
        "open": open_spans,
        "complete": not open_spans and bool(events),
        "dropped": dropped,
        "tree": _trace_tree(events),
    }


# ---------------------------------------------------------------------------
# Export surfaces
# ---------------------------------------------------------------------------


def _series():
    """Raw (counters, gauges, hists), with the degradation registry
    (resilience.DEGRADATIONS) folded in as ``degradation_active{name}``
    gauges of the same namespace."""
    c = dict(_COUNTERS)
    g = dict(_GAUGES)
    h = dict(_HISTS)
    from .resilience import DEGRADATIONS

    for nm in list(DEGRADATIONS):
        g[("degradation_active", (("name", nm),))] = 1.0
    # the persistent plan tier's process-wide accounting, as the
    # aot_cache_* series (quest_tpu/telemetry.py:686-700)
    from . import aotcache as _aotcache

    a = _aotcache.stats()
    if a["enabled"] or any(a[k] for k in ("hits", "misses", "puts",
                                          "evictions", "errors", "bytes")):
        for nm in ("hits", "misses", "puts", "evictions", "errors"):
            c[(f"aot_cache_{nm}_total", ())] = float(a[nm])
        c[("aot_compile_seconds_saved_total", ())] = float(
            a["saved_seconds"])
        g[("aot_cache_bytes", ())] = float(a["bytes"])
    return c, g, h


def _label_str(labels: tuple) -> str:
    return ",".join(f"{k}={v}" for k, v in labels)


def snapshot() -> dict:
    """The whole registry as a nested dict:
    ``{"mode", "counters": {name: {label_str: value}}, "gauges": ...,
    "histograms": {name: {label_str: {count, sum, min, max, buckets}}}}``.
    Returns ``{}`` when telemetry is off."""
    if not _mode:
        return {}
    c, g, h = _series()
    out = {"mode": mode_name(), "counters": {}, "gauges": {},
           "histograms": {}}
    for (name, labels), v in sorted(c.items()):
        out["counters"].setdefault(name, {})[_label_str(labels)] = v
    for (name, labels), v in sorted(g.items()):
        out["gauges"].setdefault(name, {})[_label_str(labels)] = v
    for (name, labels), hist in sorted(h.items()):
        out["histograms"].setdefault(
            name, {})[_label_str(labels)] = hist.as_dict()
    return out


def counter_total(name: str) -> float:
    """Sum of the counter ``name`` across every label set (0 when absent
    or telemetry is off)."""
    if not _mode:
        return 0.0
    c, _g, _h = _series()
    return float(sum(v for (n, _l), v in c.items() if n == name))


def counter_value(name: str, /, **labels) -> float:
    """One labeled counter series' value (0 when absent)."""
    if not _mode:
        return 0.0
    c, _g, _h = _series()
    return float(c.get((name, _label_key(labels)), 0))


def counter_sum(name: str, /, **labels) -> float:
    """Sum of the counter ``name`` over every series whose labels are a
    SUPERSET of ``labels`` — e.g. ``counter_sum("exchanges_total",
    op="window_remap")`` folds the per-chunk-config series into the one
    total the reconciliation loop compares against its prediction."""
    if not _mode:
        return 0.0
    want = _label_key(labels)
    c, _g, _h = _series()
    return float(sum(
        v for (n, l), v in c.items()
        if n == name and set(want) <= set(l)))


def gauge_max(name: str) -> Optional[float]:
    """Max of the gauge ``name`` across its label sets (None when absent
    or telemetry is off) — e.g. the peak ``hbm_watermark_bytes`` over
    devices for getEnvironmentString / reportPerf."""
    if not _mode:
        return None
    _c, g, _h = _series()
    vals = [v for (n, _l), v in g.items() if n == name]
    return max(vals) if vals else None


def _esc(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace("\n", r"\n")


def _prom_labels(labels: tuple, extra: tuple = ()) -> str:
    items = tuple(labels) + tuple(extra)
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(str(v))}"' for k, v in items) + "}"


def _num(v: float) -> str:
    f = float(v)
    # the text exposition format spells non-finite values +Inf/-Inf/NaN;
    # Python's repr() says inf/nan, which Prometheus parsers reject
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    if math.isnan(f):
        return "NaN"
    return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)


def prometheus_text() -> str:
    """The registry in Prometheus text exposition format (counters,
    gauges, and histograms with cumulative ``le`` buckets).  Empty
    string when telemetry is off."""
    if not _mode:
        return ""
    c, g, h = _series()
    lines = []
    seen_type = set()

    def typeline(name, kind):
        if name not in seen_type:
            seen_type.add(name)
            lines.append(f"# TYPE {name} {kind}")

    for (name, labels), v in sorted(c.items()):
        typeline(name, "counter")
        lines.append(f"{name}{_prom_labels(labels)} {_num(v)}")
    for (name, labels), v in sorted(g.items()):
        typeline(name, "gauge")
        lines.append(f"{name}{_prom_labels(labels)} {_num(v)}")
    for (name, labels), hist in sorted(h.items()):
        typeline(name, "histogram")
        cum = 0
        for bound, n in zip(hist.bounds, hist.buckets):
            cum += n
            lines.append(
                f"{name}_bucket"
                f"{_prom_labels(labels, (('le', repr(float(bound))),))}"
                f" {cum}")
        lines.append(
            f"{name}_bucket{_prom_labels(labels, (('le', '+Inf'),))}"
            f" {hist.count}")
        lines.append(f"{name}_sum{_prom_labels(labels)} {_num(hist.total)}")
        lines.append(f"{name}_count{_prom_labels(labels)} {hist.count}")
    return "\n".join(lines) + ("\n" if lines else "")


def summary() -> str:
    """One compact line for getEnvironmentString's ``[telemetry: ...]``
    block: the mode plus every counter total aggregated over labels;
    zero-valued totals are dropped."""
    if not _mode:
        return "off"
    totals: dict = {}
    counters, _gauges, _hists = _series()
    for (name, _labels), v in counters.items():
        totals[name] = totals.get(name, 0) + v
    parts = [mode_name()]
    for name in sorted(totals):
        if not totals[name]:
            continue
        short = name[:-6] if name.endswith("_total") else name
        parts.append(f"{short}={_num(totals[name])}")
    return " ".join(parts)


def perf_report(env=None) -> str:
    """Multi-line human-readable perf report (the string behind
    ``reportPerf``)."""
    lines = [f"quest_tpu_torch perf report (telemetry={mode_name()})"]
    if env is not None:
        from .env import get_environment_string

        lines.append(get_environment_string(env))
    snap = snapshot()
    if not snap:
        lines.append("telemetry is off (QT_TELEMETRY=off)")
        return "\n".join(lines)
    if snap["counters"]:
        lines.append("counters:")
        for name, series in snap["counters"].items():
            for labels, v in series.items():
                tag = f"{{{labels}}}" if labels else ""
                lines.append(f"  {name}{tag} = {_num(v)}")
    if snap["gauges"]:
        lines.append("gauges:")
        for name, series in snap["gauges"].items():
            for labels, v in series.items():
                tag = f"{{{labels}}}" if labels else ""
                lines.append(f"  {name}{tag} = {_num(v)}")
    if snap["histograms"]:
        lines.append("histograms:")
        for name, series in snap["histograms"].items():
            for labels, hd in series.items():
                tag = f"{{{labels}}}" if labels else ""
                mean = hd["sum"] / hd["count"] if hd["count"] else 0.0
                lines.append(
                    f"  {name}{tag}: count={hd['count']} "
                    f"sum={hd['sum']:.6g} mean={mean:.6g} "
                    f"max={hd['max'] if hd['max'] is not None else '-'}")
    # per-tier exchange volume (parallel/topology.py): the ici/dcn split
    # of every exchange series — sums exactly to the flat totals
    tier_lines = []
    for tier in ("ici", "dcn"):
        tc = counter_sum("exchanges_total", tier=tier)
        tb = counter_sum("exchange_bytes_total", tier=tier)
        if tc or tb:
            tier_lines.append(f"  {tier}: exchanges={_num(tc)} "
                              f"bytes/shard={_num(tb)}")
    if tier_lines:
        lines.append("exchange tiers (per-shard bytes by interconnect):")
        lines.extend(tier_lines)
    # circuit-optimizer activity (optimizer.py, docs/design.md §26):
    # stream rewrites ahead of the fusion planner, by transform kind
    removed = counter_total("optimizer_gates_removed_total")
    wmerged = counter_total("optimizer_windows_merged_total")
    if removed or wmerged:
        from . import optimizer as _optimizer

        by_kind = " ".join(
            f"{k}={_num(counter_sum('optimizer_gates_removed_total', kind=k))}"
            for k in ("cancel", "merge", "diag_coalesce", "perm_coalesce")
            if counter_sum("optimizer_gates_removed_total", kind=k))
        lines.append(f"circuit optimizer (mode={_optimizer.mode()}):")
        lines.append(f"  gates removed: total={_num(removed)} {by_kind}")
        lines.append(f"  remap windows merged: {_num(wmerged)}")
        secs = snap["histograms"].get("optimizer_seconds", {})
        tot_n = sum(hd["count"] for hd in secs.values())
        if tot_n:
            tot_s = sum(hd["sum"] for hd in secs.values())
            lines.append(
                f"  optimize time: count={tot_n} "
                f"mean={tot_s / tot_n:.6g}s")
    perm = counter_total("permutation_gates_total")
    sparse = counter_total("sparse_inits_total")
    if perm or sparse:
        lines.append("permutation fast paths (§28):")
        if perm:
            by_route = " ".join(
                f"{r}={_num(counter_sum('permutation_gates_total', route=r))}"
                for r in ("relabel", "gather", "exchange")
                if counter_sum("permutation_gates_total", route=r))
            lines.append(f"  gates: total={_num(perm)} {by_route}")
        if sparse:
            lines.append(
                f"  sparse inits: {_num(sparse)} "
                f"(amps={_num(counter_total('sparse_init_amps_total'))})")
    # §29 window megakernel: per-route dispatch split and the HBM
    # round-trips the last drain paid per fused plan window
    mega_n = counter_total("megakernel_dispatch_total")
    if mega_n:
        from .ops import fused as _fused

        by_route = " ".join(
            f"{r}={_num(counter_sum('megakernel_dispatch_total', route=r))}"
            for r in ("mega", "fallback")
            if counter_sum("megakernel_dispatch_total", route=r))
        lines.append(
            f"window megakernel (§29, mode={_fused.megakernel_mode()}):")
        lines.append(f"  dispatches: total={_num(mega_n)} {by_route}")
        trips = gauge_max("window_hbm_round_trips")
        if trips is not None:
            lines.append(
                f"  hbm_round_trips/plan_window={trips:.3g} "
                f"(1.0 = one read + one write per fused window)")
    # §30 per-op wall-time attribution: each dispatched drain group's
    # wall time, keyed by its dominant plan-entry family (megawin /
    # winfused / permfast / channel / remap).  When the measured
    # per-dispatch mean sits within 10% of the host's per-program
    # dispatch floor (the per_program_dispatch_seconds gauge), the route
    # is labeled dispatch_bound.
    routes = snap["histograms"].get("plan_route_seconds", {})
    if routes:
        floor = gauge_max("per_program_dispatch_seconds")
        lines.append("per-op attribution (§30, wall time by plan-entry "
                     "route):")
        for labels, hd in sorted(routes.items()):
            mean = hd["sum"] / hd["count"] if hd["count"] else 0.0
            verdict = ""
            if floor and hd["count"] and mean <= floor * 1.10:
                verdict = "  [dispatch_bound: mean within 10% of the " \
                          "host dispatch floor]"
            lines.append(
                f"  {labels}: dispatches={hd['count']} "
                f"total={hd['sum']:.6g}s mean={mean:.6g}s{verdict}")
        if floor:
            lines.append(
                f"  dispatch floor: {floor:.3g}s/program "
                f"(introspect.measure_dispatch_floor)")
    # the sharded drain's predicted-vs-measured reconciliation
    # (introspect.reconcile_drain records the predictions)
    pred_c = counter_sum("predicted_exchanges_total", op="window_remap")
    meas_c = counter_sum("exchanges_total", op="window_remap")
    pred_b = counter_sum("predicted_exchange_bytes_total", op="window_remap")
    meas_b = counter_sum("exchange_bytes_total", op="window_remap")
    drift = counter_total("model_drift_total")
    if pred_c or drift:
        lines.append("reconciliation (window remaps, predicted vs measured):")
        lines.append(f"  exchanges: predicted={_num(pred_c)} "
                     f"measured={_num(meas_c)}")
        lines.append(f"  bytes/shard: predicted={_num(pred_b)} "
                     f"measured={_num(meas_b)}")
        verdict = ("MODEL DRIFT" if drift else "cost model holds")
        lines.append(f"  model_drift_total={_num(drift)} ({verdict})")
    # serving layer: queue pressure, occupancy and the preemption
    # history — pure counter/gauge reads, empty until a serving layer
    # records these series
    sub = counter_total("serve_jobs_submitted_total")
    if sub:
        done_n = counter_total("serve_jobs_completed_total")
        rej = counter_total("serve_jobs_rejected_total")
        failed = counter_total("serve_jobs_failed_total")
        pre = counter_total("preemptions_total")
        res = counter_total("serve_resumes_total")
        depth = gauge_max("serve_queue_depth")
        occ = gauge_max("serve_bank_occupancy")
        lines.append("serving (continuous batcher):")
        lines.append(
            f"  jobs: submitted={_num(sub)} completed={_num(done_n)} "
            f"rejected={_num(rej)} failed={_num(failed)}")
        lines.append(
            f"  preemptions={_num(pre)} resumes={_num(res)} "
            f"queue_depth={_num(depth) if depth is not None else '-'} "
            f"bank_occupancy="
            f"{f'{occ:.3f}' if occ is not None else '-'}")
        wait = snap["histograms"].get("serve_queue_wait_seconds", {})
        tot_n = sum(hd["count"] for hd in wait.values())
        tot_s = sum(hd["sum"] for hd in wait.values())
        if tot_n:
            wmax = max(hd["max"] for hd in wait.values()
                       if hd["max"] is not None)
            lines.append(
                f"  queue_wait_seconds: count={tot_n} "
                f"mean={tot_s / tot_n:.6g} max={wmax:.6g}")
    # serving resilience (docs/design.md §27): bank retries, poison
    # quarantine, failover/heal history, and the live degraded flag
    retr = counter_total("serve_bank_retries_total")
    quar = counter_total("serve_jobs_quarantined_total")
    fo = counter_total("serve_failovers_total")
    heals = counter_total("serve_heals_total")
    deg = gauge_max("serve_degraded")
    if retr or quar or fo or heals or deg:
        by_reason = " ".join(
            f"{r}={_num(counter_sum('serve_bank_retries_total', reason=r))}"
            for r in ("transient", "failover", "poison")
            if counter_sum("serve_bank_retries_total", reason=r))
        lines.append("serving resilience:")
        lines.append(f"  bank retries: total={_num(retr)}"
                     + (f" ({by_reason})" if by_reason else ""))
        lines.append(
            f"  quarantined={_num(quar)} failovers={_num(fo)} "
            f"heals={_num(heals)} degraded={int(deg or 0)}")
        mttr = gauge_max("serve_failover_mttr_seconds")
        if mttr is not None:
            lines.append(f"  failover_mttr_seconds={mttr:.4g}")
    # §31 the persistent plan cache (aotcache.py) + serve warm pool: pure
    # counter reads, the reference's block and names; an entry here is a
    # plan, and the seconds saved are planning seconds
    aot_h = counter_total("aot_cache_hits_total")
    aot_m = counter_total("aot_cache_misses_total")
    aot_p = counter_total("aot_cache_puts_total")
    aot_e = counter_total("aot_cache_errors_total")
    if aot_h or aot_m or aot_p or aot_e:
        lines.append("AOT cache / warm pool (§31):")
        lines.append(
            f"  plans: hits={_num(aot_h)} misses={_num(aot_m)} "
            f"puts={_num(aot_p)} "
            f"evictions={_num(counter_total('aot_cache_evictions_total'))} "
            f"errors={_num(aot_e)}")
        size = gauge_max("aot_cache_bytes")
        saved = counter_total("aot_compile_seconds_saved_total")
        lines.append(
            f"  bytes={_num(size or 0)} "
            f"compile_seconds_saved={saved:.4g}")
        depth = gauge_max("serve_warm_pool_depth")
        backlog = gauge_max("serve_prewarm_backlog")
        if depth is not None or backlog is not None:
            lines.append(
                f"  warm pool: depth={_num(depth or 0)} "
                f"peak_backlog={_num(backlog or 0)} "
                f"prewarms={_num(counter_total('serve_prewarm_total'))}")
        first = snap["histograms"].get("first_request_seconds", {})
        for labels, hd in sorted(first.items()):
            mean = hd["sum"] / hd["count"] if hd["count"] else 0.0
            lines.append(
                f"  first_request_seconds{{{labels}}}: "
                f"count={hd['count']} mean={mean:.6g} "
                f"max={hd['max'] if hd['max'] is not None else '-'}")
    # §30 observability surfaces: flight-ring occupancy / dump history
    # and the request-trace store (the /tracez population)
    fl = len(_FLIGHT)
    dumps = counter_total("flight_dumps_total")
    if fl or dumps:
        lines.append(
            f"flight recorder: {fl} event(s) buffered, "
            f"{int(dumps)} dump(s) written")
    if _JOB_TRACES:
        lines.append(
            f"request traces: {len(_JOB_TRACES)} trace(s) held (tracez)")
    peak = gauge_max("hbm_watermark_bytes")
    if peak is not None:
        lines.append(f"memory: hbm_watermark_bytes peak={_num(peak)} "
                     f"({peak / (1 << 20):.1f} MiB)")
    # the memory governor: budget, residency, spill and OOM history
    from . import governor as _governor

    gov_line = _governor.summary_line(env)
    if gov_line:
        lines.append(gov_line)
    return "\n".join(lines)


def report_perf(env=None) -> None:
    """Print the perf report — the telemetry member of the reference's
    ``report*`` family (reportQuESTEnv, reportQuregParams, ...)."""
    print(perf_report(env))
