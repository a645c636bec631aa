"""Telemetry (M16a) in the port against the JAX package.

The same API stream (a depth-4 config-2-style circuit, a measurement and
a calcProbOfOutcome) runs through both packages after a reset of both
registries; the counter series both record are equal, series for
series: dispatch_total{family}, fusion drains and windows, plan-cache
hits and misses, optimizer_gates_removed_total{kind},
measurement_shots_total, the permutation and route series and, on the
8-shard meshes, exchanges_total / exchange_bytes_total{op,tier}.
reportPerf prints its sections for the same series.  The reference's
registry, off-mode, Prometheus, trace-ring, thread, flight-recorder,
request-trace and per-op attribution cases run on both modules, each
with the same result.  Reference registers use
``qt.createQuESTEnv(num_devices=R)``; float64 (tests/conftest.py).
"""

import collections
import json
import threading
import time

import numpy as np
import pytest
import torch

import quest_tpu as qt
from quest_tpu import fusion as RF
from quest_tpu import optimizer as RO
from quest_tpu import telemetry as RT
import quest_tpu_torch as tq
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import optimizer as PO
from quest_tpu_torch import precision
from quest_tpu_torch import telemetry as PT
from quest_tpu_torch.parallel import dist as PD

MODULES = {"reference": RT, "port": PT}
N = 10


@pytest.fixture(autouse=True)
def both_on():
    """Both registries on and empty; the modes restored afterwards."""
    old = {k: m.mode_name() for k, m in MODULES.items()}
    old_prec = precision.get_precision()
    tq.set_precision(2)
    for m in MODULES.values():
        m.configure("on")
        m.reset()
    yield
    for k, m in MODULES.items():
        m.reset()
        m.configure(old[k])
    tq.set_precision(old_prec)


@pytest.fixture(params=sorted(MODULES))
def T(request):
    return MODULES[request.param]


def _stream(pk, env, n=N, depth=4, seed=3):
    """Config 2's circuit shape at ``n`` qubits (random 1q unitaries and
    an alternating CNOT ladder), a cancelling H pair for the optimizer,
    then reads and a measurement."""
    rng = np.random.default_rng(seed)
    pk.seedQuEST(env, [5])
    q = pk.createQureg(n, env)
    with pk.gateFusion(q):
        for d in range(depth):
            for t in range(n):
                a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
                pk.unitary(q, t, np.linalg.qr(a)[0])
            for t in range(d % 2, n - 1, 2):
                pk.controlledNot(q, t, t + 1)
            pk.hadamard(q, 0)
            pk.hadamard(q, 0)
    p = pk.calcProbOfOutcome(q, n - 1, 0)
    m = pk.measure(q, 0)
    p2 = pk.calcProbOfOutcome(q, 1, 0)
    return q, (p, m, p2)


# the reference's series the port does not record: XLA's compile cache
# and the jit retrace count (the drain's model reconciliation, recorded by
# both, is compared with the rest)
_REF_ONLY = {"compile_cache_hits_total", "compile_cache_misses_total",
             "fusion_retrace_total"}
_REQUIRED = {"dispatch_total", "fusion_drains_total", "fusion_windows_total",
             "fusion_plan_cache_misses_total",
             "optimizer_gates_removed_total", "measurement_shots_total",
             "plan_route_dispatch_total"}


def _run_both(R):
    for m in MODULES.values():
        m.reset()
    RF._plan_cache.clear()
    PF._plan_cache.clear()
    RO.clear_cache()
    PO._cache.clear()
    renv = qt.createQuESTEnv(num_devices=R)
    penv = tq.createQuESTEnv(devices=["cpu"] * R) if R > 1 \
        else tq.createQuESTEnv(device="cpu")
    rq, rvals = _stream(qt, renv)
    pq, pvals = _stream(tq, penv)
    return (rvals, pvals, RT.snapshot()["counters"],
            PT.snapshot()["counters"], RT.perf_report(), PT.perf_report())


@pytest.fixture(scope="module")
def streams():
    """(reference values, port values, counters, counters, reports,
    reports) of the stream at R = 1 and 8, run once per module."""
    memo = {}

    def get(R):
        if R not in memo:
            RT.configure("on")
            PT.configure("on")
            memo[R] = _run_both(R)
        return memo[R]
    return get


@pytest.mark.parametrize("R", [1, 8])
def test_counters_equal_the_reference(streams, R):
    rvals, pvals, rc, pc = streams(R)[:4]
    assert abs(rvals[0] - pvals[0]) < 1e-10
    assert rvals[1] == pvals[1]
    assert abs(rvals[2] - pvals[2]) < 1e-10
    assert _REQUIRED <= set(rc) and _REQUIRED <= set(pc)
    if R > 1:
        assert {"exchanges_total", "exchange_bytes_total"} <= set(pc)
    assert set(pc) <= set(rc)
    assert set(rc) - set(pc) <= _REF_ONLY
    for name in set(rc) & set(pc):
        assert rc[name] == pc[name], name


def test_dispatch_families_and_drain_windows(streams):
    pc = streams(1)[3]
    assert pc["dispatch_total"]["family=unitary"] == 4 * N + 4 * 2
    assert pc["dispatch_total"]["family=not"] == sum(
        len(range(d % 2, N - 1, 2)) for d in range(4))
    assert pc["fusion_drains_total"][""] == 1
    assert pc["measurement_shots_total"][""] == 1


def test_hist_bounds_equal_the_reference():
    assert PT.HIST_BOUNDS == RT.HIST_BOUNDS
    assert PT._DEFAULT_BOUNDS == RT._DEFAULT_BOUNDS


def _sections(report: str) -> set:
    """The report's section headers (unindented lines), without the
    title, the environment line and the values of the memory line."""
    out = set()
    for line in report.splitlines()[1:]:
        if line.startswith(" ") or line.startswith("EnvType="):
            continue
        out.add(line.split(" peak=")[0].split("(mode=")[0])
    return out


@pytest.mark.parametrize("R", [1, 8])
def test_report_perf_sections_match(streams, R):
    rep_r, rep_p = (_sections(r) for r in streams(R)[4:])
    # the sharded drain reconciles (introspect.reconcile_drain): the
    # reconciliation section is in both reports
    assert rep_r == rep_p
    if R > 1:
        assert "reconciliation (window remaps, predicted vs measured):" \
            in rep_p
    assert {"counters:", "histograms:", "memory: hbm_watermark_bytes"} \
        <= rep_p


def test_report_perf_prints_env_and_counters(capsys):
    env = tq.createQuESTEnv(device="cpu")
    tq.hadamard(tq.createQureg(2, env), 0)
    tq.reportPerf(env)
    out = capsys.readouterr().out
    assert "quest_tpu_torch perf report" in out
    assert "dispatch_total{family=unitary}" in out
    assert "EnvType=quest_tpu_torch" in out
    assert "[telemetry: on" in out


# ---------------------------------------------------------------------------
# Registry semantics, the same on both modules
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_labels_canonical_and_isolated(self, T):
        T.inc("exchanges_total", 1, op="remap", chunks="4")
        T.inc("exchanges_total", 2, chunks="4", op="remap")
        T.inc("exchanges_total", 5, op="swap", chunks=4)
        snap = T.snapshot()["counters"]["exchanges_total"]
        assert snap == {"chunks=4,op=remap": 3, "chunks=4,op=swap": 5}
        assert T.counter_value("exchanges_total", op="remap", chunks=4) == 3
        assert T.counter_sum("exchanges_total", chunks="4") == 8

    def test_histogram_stats_and_buckets(self, T):
        for v in (0.0005, 0.05, 0.05, 3.0):
            T.observe("lat_seconds", v)
        h = T.snapshot()["histograms"]["lat_seconds"][""]
        assert h["count"] == 4 and h["min"] == 0.0005 and h["max"] == 3.0
        assert h["buckets"]["0.001"] == 1 and h["buckets"]["0.1"] == 3
        assert list(h["buckets"].values())[-1] == 4


def test_registry_snapshots_equal(monkeypatch):
    from quest_tpu import resilience as RR
    from quest_tpu_torch import resilience as PR

    # both degradation registries empty: they fold into the snapshots
    monkeypatch.setattr(RR, "DEGRADATIONS", {})
    monkeypatch.setattr(PR, "DEGRADATIONS", {})
    for m in MODULES.values():
        m.inc("a_total", 3, op="x")
        m.set_gauge("g", 2.5, device="d")
        m.observe("fusion_window_gates", 7)
        m.observe("exchange_latency_seconds", 2e-5, op="drain")
    r = {k: v for k, v in RT.snapshot().items()}
    p = PT.snapshot()
    for part in ("counters", "gauges", "histograms"):
        keep = {k: v for k, v in r[part].items()
                if not k.startswith("compile_cache_")}
        assert keep == p[part], part
    assert "compile_cache" not in PT.prometheus_text()
    assert PT.prometheus_text() == "\n".join(
        line for line in RT.prometheus_text().splitlines()
        if "compile_cache" not in line) + "\n"


def test_degradation_becomes_series(monkeypatch):
    from quest_tpu_torch import resilience as PR

    monkeypatch.setattr(PR, "DEGRADATIONS", {})
    with pytest.warns(UserWarning, match="unit_test"):
        PR.record_degradation("unit_test", "synthetic downgrade")
    snap = PT.snapshot()
    assert snap["counters"]["degradations_total"]["name=unit_test"] == 1
    assert snap["gauges"]["degradation_active"]["name=unit_test"] == 1.0
    assert tq.degradation_report() == {"unit_test": "synthetic downgrade"}


# ---------------------------------------------------------------------------
# The reference's classes, each case on both modules
# ---------------------------------------------------------------------------


class TestOffMode:
    def test_off_yields_empty_everything(self, T):
        T.inc("pre_total")
        T.configure("off")
        T.inc("post_total")
        assert T.snapshot() == {}
        assert T.prometheus_text() == ""
        assert T.counter_total("post_total") == 0
        T.configure("on")
        assert T.counter_total("pre_total") == 1
        assert T.counter_total("post_total") == 0

    def test_off_no_trace_files(self, T, tmp_path):
        T.configure("off")
        with T.span("invisible"):
            pass
        assert T.write_trace(str(tmp_path / "t.json")) is None
        assert list(tmp_path.iterdir()) == []

    def test_env_var_resolution(self, T, monkeypatch):
        monkeypatch.setenv("QT_TELEMETRY", "off")
        assert T.configure() == "off"
        monkeypatch.setenv("QT_TELEMETRY", "trace")
        assert T.configure() == "trace"
        monkeypatch.delenv("QT_TELEMETRY")
        assert T.configure() == "on"
        with pytest.raises(ValueError, match="unknown mode"):
            T.configure("loud")

    def test_off_dispatch_is_silent(self):
        PT.configure("off")
        env = tq.createQuESTEnv(device="cpu")
        q = tq.createQureg(3, env)
        with tq.gateFusion(q):
            tq.hadamard(q, 0)
        tq.measure(q, 0)
        assert PT.snapshot() == {}
        assert "[telemetry: off]" in tq.getEnvironmentString(env)


class TestPrometheusStrictConformance:
    @pytest.fixture(autouse=True)
    def _parser(self):
        pytest.importorskip("prometheus_client")

    def _families(self, T):
        from prometheus_client.parser import text_string_to_metric_families

        return {f.name: f for f in
                text_string_to_metric_families(T.prometheus_text())}

    def test_full_registry_parses(self, T):
        T.inc("exchanges_total", 3, op="remap", chunks="2")
        T.set_gauge("hbm_bytes", 123.0, device='weird"dev\\0')
        T.observe("lat_seconds", 0.02)
        T.observe("fusion_window_gates", 3)
        fams = self._families(T)
        samples = {(s.name, tuple(sorted(s.labels.items()))): s.value
                   for f in fams.values() for s in f.samples}
        assert samples[("exchanges_total",
                        (("chunks", "2"), ("op", "remap")))] == 3
        assert samples[("hbm_bytes", (("device", 'weird"dev\\0'),))] == 123

    def test_nonfinite_values_spelled_per_spec(self, T):
        T.set_gauge("g_inf", float("inf"), k="a")
        T.set_gauge("g_ninf", float("-inf"), k="a")
        T.set_gauge("g_nan", float("nan"), k="a")
        text = T.prometheus_text()
        assert 'g_inf{k="a"} +Inf' in text
        assert 'g_ninf{k="a"} -Inf' in text
        assert 'g_nan{k="a"} NaN' in text
        self._families(T)

    def test_histogram_semantics_cumulative_and_inclusive(self, T):
        bounds = T.HIST_BOUNDS["fusion_window_gates"]
        for v in (1, 2, 10_000):
            T.observe("fusion_window_gates", v)
        f = self._families(T)["fusion_window_gates"]
        buckets = {s.labels["le"]: s.value for s in f.samples
                   if s.name == "fusion_window_gates_bucket"}
        assert buckets[repr(float(bounds[0]))] == 1
        assert buckets[repr(float(2))] == 2
        assert buckets["+Inf"] == 3
        ordered = [buckets[repr(float(b))] for b in bounds] + \
            [buckets["+Inf"]]
        assert ordered == sorted(ordered)


class TestBoundedTraceRing:
    def test_overflow_drops_oldest_and_counts(self, T, monkeypatch):
        T.configure("trace")
        monkeypatch.setattr(T, "_TRACE_MAX", 4)
        for i in range(7):
            with T.span("ring", seq=i):
                pass
        assert [e["args"]["seq"] for e in T._TRACE_EVENTS] == \
            ["3", "4", "5", "6"]
        assert T.counter_total("trace_events_dropped_total") == 3

    def test_write_trace_notes_drops_then_resets(self, T, monkeypatch,
                                                 tmp_path):
        T.configure("trace")
        monkeypatch.setattr(T, "_TRACE_MAX", 2)
        for _ in range(5):
            with T.span("w"):
                pass
        with open(T.write_trace(str(tmp_path / "t.json"))) as f:
            doc = json.load(f)
        assert len(doc["traceEvents"]) == 2
        assert doc["otherData"]["trace_events_dropped"] == 3
        with T.span("w"):
            pass
        with open(T.write_trace(str(tmp_path / "t2.json"))) as f:
            assert "otherData" not in json.load(f)

    def test_nested_spans_chrome_schema(self, T, tmp_path):
        T.configure("trace")
        with T.span("outer", phase="drain"):
            with T.span("inner"):
                pass
        with open(T.write_trace(str(tmp_path / "trace.json"))) as f:
            events = json.load(f)["traceEvents"]
        assert [e["name"] for e in events] == ["inner", "outer"]
        inner, outer = events
        assert all(e["ph"] == "X" for e in events)
        assert outer["ts"] <= inner["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + 1e-3
        assert outer["args"] == {"phase": "drain"}


class TestThreadExactness:
    def test_concurrent_writers_exact_totals(self, T):
        workers, per = 8, 300
        fast = T.counter_key("contended_fast_total", lane="x")
        barrier = threading.Barrier(workers)

        def work(k):
            barrier.wait()
            for _ in range(per):
                T.inc("contended_total", worker=k % 2)
                T.inc_key(fast)
                T.observe("contended_seconds", 1e-6)
                T.set_gauge("contended_gauge", float(k))

        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert T.counter_total("contended_total") == workers * per
        assert T.counter_total("contended_fast_total") == workers * per
        hd = T.snapshot()["histograms"]["contended_seconds"][""]
        assert hd["count"] == workers * per


class TestFlightRecorder:
    def test_ring_is_bounded_oldest_dropped(self, T, monkeypatch):
        monkeypatch.setattr(T, "_FLIGHT", collections.deque(maxlen=3))
        for i in range(6):
            T.flight_event("tick", seq=i)
        assert [e["seq"] for e in T.flight_snapshot()] == [3, 4, 5]

    def test_dump_parseable_and_ring_not_drained(self, T, tmp_path):
        T.flight_event("bank_dissolved", bank=1, reason="transient", jobs=3)
        T.flight_event("admission_rejected", tenant="acme", limit=4)
        path = T.dump_flight(str(tmp_path / "f.json"), reason="quarantine",
                             tenant="acme", job=7, error=ValueError("boom"))
        with open(path) as f:
            doc = json.load(f)
        assert doc["reason"] == "quarantine"
        assert doc["context"] == {"tenant": "acme", "job": 7,
                                  "error": "boom"}
        assert [e["kind"] for e in doc["events"]] == \
            ["bank_dissolved", "admission_rejected"]
        assert T.counter_value("flight_dumps_total",
                               reason="quarantine") == 1
        p2 = T.dump_flight(str(tmp_path / "g.json"), reason="failover")
        with open(p2) as f:
            assert len(json.load(f)["events"]) == 2

    def test_reserved_keys_and_stringification(self, T):
        T.flight_event("k", ts=-1.0, kind="spoof", err=ValueError("x"), n=2)
        ev = T.flight_snapshot()[-1]
        assert ev["kind"] == "k" and ev["ts"] >= 0
        assert ev["err"] == "x" and ev["n"] == 2
        json.dumps(ev)

    def test_off_mode_records_nothing_writes_nothing(self, T, tmp_path):
        T.configure("off")
        T.flight_event("tick")
        target = tmp_path / "f.json"
        assert T.dump_flight(str(target), reason="x") is None
        assert not target.exists()
        T.configure("on")
        assert T.flight_snapshot() == []


class TestRequestTraces:
    def _lifecycle(self, T, tid):
        T.trace_begin(tid, "job", tenant="acme")
        T.trace_point(tid, "serve.admit", queue_depth=1)
        with T.trace_span(tid, "serve.window", bank=0):
            pass
        T.trace_add(tid, "serve.window", t0=time.perf_counter(), dur=1e-3,
                    bank=0, window=1)
        T.trace_point(tid, "serve.complete", outcomes=2)
        T.trace_end(tid, status="done")

    def test_complete_trace_well_nested(self, T):
        self._lifecycle(T, "s0-j1")
        tz = T.tracez("s0-j1")
        assert tz["complete"] and not tz["open"] and tz["dropped"] == 0
        assert [e["name"] for e in tz["events"]] == \
            ["job", "serve.admit", "serve.window", "serve.window",
             "serve.complete"]
        roots = tz["tree"]
        assert len(roots) == 1 and roots[0]["name"] == "job"
        assert roots[0]["args"] == {"tenant": "acme", "status": "done"}
        assert len(roots[0]["children"]) == 4

    def test_index_unknown_id_and_open_spans(self, T):
        self._lifecycle(T, "a")
        T.trace_begin("b", "job")
        assert T.tracez("nope") is None
        idx = T.tracez()["traces"]
        assert idx["a"]["complete"] and idx["a"]["events"] == 5
        assert idx["b"]["open"] == ["job"] and not idx["b"]["complete"]
        assert T.trace_ids() == ["a", "b"]

    def test_id_eviction_oldest_first(self, T, monkeypatch):
        monkeypatch.setattr(T, "_TRACEZ_IDS", 2)
        for tid in ("t1", "t2", "t3"):
            T.trace_point(tid, "x")
        assert T.trace_ids() == ["t2", "t3"]

    def test_per_id_event_cap_counts_drops(self, T, monkeypatch):
        monkeypatch.setattr(T, "_TRACEZ_EVENTS", 3)
        for i in range(5):
            T.trace_point("t", "p", seq=i)
        tz = T.tracez("t")
        assert len(tz["events"]) == 3 and tz["dropped"] == 2

    def test_mirrors_into_flight_ring(self, T):
        self._lifecycle(T, "s1-j2")
        kinds = {(e["kind"], e.get("name")) for e in T.flight_snapshot()}
        assert ("event", "serve.admit") in kinds
        assert ("span", "job") in kinds

    def test_off_mode_records_nothing(self, T):
        T.configure("off")
        T.trace_begin("t", "job")
        T.trace_point("t", "x")
        T.trace_end("t")
        T.configure("on")
        assert T.tracez("t") is None


class TestPerOpAttribution:
    def test_report_flags_dispatch_bound_route(self, T):
        T.observe("plan_route_seconds", 0.0100, route="winfused")
        T.observe("plan_route_seconds", 0.0102, route="winfused")
        T.observe("plan_route_seconds", 0.5, route="megawin")
        T.set_gauge("per_program_dispatch_seconds", 0.0095)
        lines = {l.split(":")[0].strip(): l
                 for l in T.perf_report().splitlines() if "route=" in l}
        assert "dispatch_bound" in lines["route=winfused"]
        assert "dispatch_bound" not in lines["route=megawin"]

    def test_no_floor_gauge_no_verdict(self, T):
        T.observe("plan_route_seconds", 1e-4, route="winfused")
        rep = T.perf_report()
        assert "per-op attribution" in rep and "dispatch_bound" not in rep

    @pytest.mark.parametrize("mode", ["on", "trace"])
    def test_drain_records_route_series(self, mode):
        PT.configure(mode)
        h = (1 / np.sqrt(2)) * np.array([[1.0, 1], [1, -1]], dtype=complex)
        q = tq.createQureg(4, tq.createQuESTEnv(device="cpu"))
        with tq.gateFusion(q):
            for t in range(4):
                tq.unitary(q, t, h)
        tq.calcTotalProb(q)
        routes = PT.snapshot()["histograms"]["plan_route_seconds"]
        assert list(routes) == ["route=winfused"]
        assert PT.counter_total("plan_route_dispatch_total") == 1


# ---------------------------------------------------------------------------
# The port's device hooks
# ---------------------------------------------------------------------------


def test_span_lands_in_a_torch_profiler_trace(tmp_path):
    from quest_tpu_torch import utils

    q = tq.createQureg(8, tq.createQuESTEnv(device="cpu"))
    with utils.profiling.trace(str(tmp_path / "tr")) as prof:
        with tq.gateFusion(q):
            for t in range(8):
                tq.hadamard(q, t)
    names = [e.name for e in prof.events()]
    assert names.count("fusion.drain") == 1
    assert names.count("fusion.plan") + PT.counter_total(
        "fusion_plan_cache_hits_total") == 1
    assert (tmp_path / "tr" / "trace.json").exists()


def test_annotate_takes_nvtx_only_with_cuda(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda.nvtx, "range_push",
                        lambda name: calls.append(("push", name)))
    monkeypatch.setattr(torch.cuda.nvtx, "range_pop",
                        lambda: calls.append(("pop",)))
    with PT.span("unit.region"):
        pass
    assert calls == [("push", "unit.region"), ("pop",)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls.clear()
    with PT.span("unit.region"):
        pass
    assert calls == []


def test_timed_and_memory_watermark():
    from quest_tpu_torch.utils import profiling

    with profiling.timed("unit_block", sync=torch.zeros(2)) as t:
        pass
    h = PT.snapshot()["histograms"]["timed_seconds"]["label=unit_block"]
    assert h["count"] == 1 and abs(h["sum"] - t["seconds"]) < 1e-9
    wm = profiling.memory_watermark()
    assert wm["host"]["peak_bytes_in_use"] > 0
    g = PT.snapshot()["gauges"]
    assert g["hbm_watermark_bytes"]["device=host"] > 0
    assert "device_memory_watermark_bytes" in PT.prometheus_text()


def test_drain_samples_the_watermark_and_counts_drains():
    q = tq.createQureg(4, tq.createQuESTEnv(device="cpu"))
    for _ in range(2):
        with tq.gateFusion(q):
            tq.hadamard(q, 1)
    assert q._drain_count == 2
    assert PT.counter_total("fusion_drains_total") == 2
    assert PT.gauge_max("hbm_watermark_bytes") > 0


def test_dist_counters_are_the_registry():
    PD.reset_counters()
    PD.record_exchange("unit", 2, 64, chunks=4, tier="ici")
    assert PD.counter_sum("exchanges_total", op="unit") == 2
    assert PT.counter_value("exchanges_total", op="unit", chunks="4",
                            tier="ici") == 2
    assert PT.counter_value("exchange_bytes_total", op="unit",
                            tier="ici") == 64
    PD.reset_counters()
    assert PT.snapshot()["counters"] == {}


def test_guarded_dispatch_latency_histogram():
    out = PD.guarded_dispatch(lambda a, k=None: (a, k), 5, k=7,
                              op="unit_test", shards=8, consumes=False)
    assert out == (5, 7)
    h = PT.snapshot()["histograms"]["exchange_latency_seconds"]
    assert h["op=unit_test,shards=8"]["count"] == 1


@pytest.mark.parametrize("override,used", [("x", 1), ("6", 4)])
def test_exchange_chunk_settings_are_degradations(monkeypatch, override,
                                                  used):
    from quest_tpu_torch import resilience as PR

    monkeypatch.setattr(PR, "DEGRADATIONS", {})
    monkeypatch.setenv("QT_EXCHANGE_CHUNKS", override)
    with pytest.warns(UserWarning, match="exchange_chunks"):
        assert PD.exchange_chunks(1 << 24, backend="cuda") == used
    assert "exchange_chunks" in tq.degradation_report()
    assert "Degraded=[exchange_chunks" in tq.getEnvironmentString(
        tq.createQuESTEnv(device="cpu"))


def test_bank_series():
    from quest_tpu_torch import circuit as PC

    env = tq.createQuESTEnv(device="cpu")
    h = np.stack([(1 / np.sqrt(2)) * np.array([[1.0, 1], [1, -1]]),
                  np.zeros((2, 2))])
    sched = tq.EnsembleScheduler(4, env, max_batch=4)
    for _ in range(3):
        sched.submit([PC.Gate((0,), h), PC.Gate((1,), h)])
    sched.drain()
    assert PT.counter_total("ensemble_circuits_total") == 3
    assert PT.gauge_max("batch_occupancy") == 0.75
    assert PT.counter_value("dispatch_total", family="unitary") == 8
    hs = PT.snapshot()["histograms"]["span_seconds"]
    assert "name=batch.ensemble_drain" in hs
    tq.run_trajectories([PC.Gate((0,), h), ("dephasing", 0, 0.1)], 3, env,
                        4, seed=1)
    assert PT.counter_total("trajectory_runs_total") == 4
    assert PT.gauge_max("trajectory_noise_sites") == 1
    assert "name=batch.trajectories" in PT.snapshot()["histograms"][
        "span_seconds"]
