"""The readers of the program's spans (``qtbench/spans.py`` and the
metrics on it) on a synthetic trace and span ring: known idle time inside
each span, known op counts, the window's edges, and nothing where the
program records no spans."""

from types import SimpleNamespace

import pytest

from qtbench import harness
from qtbench import spans as SP
from qtbench import trace as TR

NS = 1_000_000_000
T0 = 1_790_000_000.0  # the profiler's clock: Unix-epoch seconds


def _rec(name, s, e, sid, parent=None, **attrs):
    return {"name": name, "start_ns": int(round((T0 + s) * NS)),
            "end_ns": int(round((T0 + e) * NS)), "id": sid,
            "parent": parent, "tid": 1, "attrs": attrs}


def _metric(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


# two circuits in the window, [1, 5] and [5, 9] s; the card busy in
# [2.5, 3.0], [3.5, 4.0] and [7.0, 8.0]
DEVICE = [TR.DeviceEvent("k", T0 + 2.5, T0 + 3.0),
          TR.DeviceEvent("k", T0 + 3.5, T0 + 4.0),
          TR.DeviceEvent("k", T0 + 7.0, T0 + 8.0)]
HOST = [("qtbench.circuit", T0 + 1.0, T0 + 5.0),
        ("qtbench.circuit", T0 + 5.0, T0 + 9.0)]
RING = [
    # set-up, before the window: the first drain's lookup lasts 0.25 s
    _rec("fusion.lookup", -3.0, -2.75, 1, source="planned"),
    _rec("fusion.dispatch", -2.5, -2.0, 2, gatherperm=80),
    # circuit 1
    _rec("fusion.capture", 1.1, 2.0, 10, gates=770, drain=11),
    _rec("fusion.optimize", 2.0, 2.2, 12, 11, drain=11),
    _rec("fusion.lookup", 2.2, 2.4, 13, 11, drain=11, source="memory"),
    _rec("fusion.govern", 2.4, 2.5, 14, 11, drain=11),
    _rec("fusion.dispatch", 2.5, 4.5, 15, 11, drain=11, gatherperm=80,
         winfused=60),
    _rec("fusion.drain", 2.0, 4.6, 11, drain=11),
    # circuit 2
    _rec("fusion.capture", 5.1, 6.0, 20, gates=770, drain=21),
    _rec("fusion.optimize", 6.0, 6.5, 22, 21, drain=21),
    _rec("fusion.lookup", 6.5, 6.7, 23, 21, drain=21, source="memory"),
    _rec("fusion.govern", 6.7, 7.0, 24, 21, drain=21),
    _rec("fusion.dispatch", 7.0, 7.5, 25, 21, drain=21, gatherperm=80,
         winfused=60),
    _rec("fusion.drain", 6.0, 7.6, 21, drain=21),
    # after the window (the harness's plan read-out)
    _rec("fusion.dispatch", 12.0, 12.5, 30, gatherperm=80),
    _rec("api.qft", 12.0, 12.5, 31),
]


@pytest.fixture
def ctx(monkeypatch):
    monkeypatch.setattr(SP, "program_spans",
                        lambda since_ns=0: [r for r in RING
                                            if r["start_ns"] >= since_ns])
    monkeypatch.setattr(SP, "ring_dropped", lambda: False)
    tr = TR.Trace(device=list(DEVICE), host=list(HOST), window_s=8.0)
    return SimpleNamespace(circuits=2, drains=2, trace=tr)


@pytest.mark.parametrize("name, want_ms", [
    # capture [1.1, 2.0] + [5.1, 6.0], all idle: 1.8 s over 2 circuits
    ("capture_idle_ms", 900.0),
    # optimize 0.2 + 0.5 s idle
    ("optimize_idle_ms", 350.0),
    # lookup 0.2 + 0.2 s idle
    ("lookup_idle_ms", 200.0),
    # dispatch [2.5, 4.5] less 1.0 busy, [7.0, 7.5] all busy
    ("dispatch_idle_ms", 500.0),
])
def test_idle_inside_each_span(ctx, name, want_ms):
    # seconds since the epoch hold about 0.24 us in a float
    assert _metric(name).read(ctx) == pytest.approx(want_ms, abs=1e-3)


def test_children_and_remainder_make_the_drain(ctx):
    """The drain's idle is its children's idle (govern too) plus what no
    child covers."""
    drain = SP.idle_within(ctx.trace, SP.window_spans(ctx.trace,
                                                      "fusion.drain"))
    parts = sum(SP.idle_within(ctx.trace, SP.window_spans(ctx.trace, n))
                for n in ("fusion.optimize", "fusion.lookup",
                          "fusion.govern", "fusion.dispatch"))
    # drain [2.0, 4.6] less 1.0 busy = 1.6; [6.0, 7.6] less 0.6 = 1.0
    assert drain == pytest.approx(2.6, abs=1e-6)
    # the remainder: [4.5, 4.6] ([7.5, 7.6] is busy)
    assert drain - parts == pytest.approx(0.1, abs=1e-6)


def test_gathers_per_circuit_counts_the_window_dispatches(ctx):
    assert _metric("gathers_per_circuit").read(ctx) == 80.0
    ctx.drains = 1     # a bank of 8 is one drain, its gathers batched
    ctx.circuits = 8
    assert _metric("gathers_per_circuit").read(ctx) == 160.0


def test_qft_idle_outside_the_window_is_not_read(ctx):
    assert _metric("qft_idle_ms").read(ctx) is None


def test_first_lookup_is_the_oldest_in_the_ring(ctx, monkeypatch):
    assert _metric("first_lookup_s").read(ctx) == pytest.approx(0.25,
                                                                abs=1e-6)
    monkeypatch.setattr(SP, "ring_dropped", lambda: True)
    assert _metric("first_lookup_s").read(ctx) is None


@pytest.mark.parametrize("name", [
    "capture_idle_ms", "optimize_idle_ms", "lookup_idle_ms",
    "dispatch_idle_ms", "qft_idle_ms", "gathers_per_circuit",
    "first_lookup_s"])
def test_nothing_without_spans(ctx, monkeypatch, name):
    monkeypatch.setattr(SP, "program_spans", lambda since_ns=0: [])
    assert _metric(name).read(ctx) is None


def test_a_program_without_the_span_ring_reads_nothing(monkeypatch):
    from quest_tpu_torch import telemetry

    monkeypatch.delattr(telemetry, "spans", raising=False)
    assert SP.program_spans() == []
