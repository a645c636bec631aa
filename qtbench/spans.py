"""The program's own span records inside the traced window, and the
card's idle time inside them.

``quest_tpu_torch.telemetry.spans()`` returns the spans the program
recorded (name, start and end in ns, id, parent, attrs) on the clock
``torch.profiler`` stamps its events with (Unix-epoch nanoseconds), so a
record lies over the trace's device events as the profiler's own ranges
do.  The window runs from the first ``qtbench.circuit`` start in the
trace to the last ``qtbench.circuit`` end.  Every reader returns None
where the program records no spans: telemetry off, or a program without
the span ring.
"""

from __future__ import annotations

from qtbench import trace as TR

# slack at both ends of the window, in seconds: a record and the
# profiler's range of the same region differ by tens of microseconds,
# and the set-up's last circuit and the read-outs after the window lie
# further away than this
SLACK_S = 1e-3


def program_spans(since_ns: int = 0) -> list:
    """The records of the program's span ring that started at or after
    ``since_ns``; [] where the program keeps none."""
    from quest_tpu_torch import telemetry

    reader = getattr(telemetry, "spans", None)
    return list(reader(since_ns)) if reader is not None else []


def ring_dropped() -> bool:
    """Whether the program's span ring dropped records (its oldest)."""
    from quest_tpu_torch import telemetry

    return telemetry.counter_total("trace_events_dropped_total") > 0


def window(trace: TR.Trace):
    """(start, end) in seconds of the traced window; None where the trace
    holds no circuit."""
    circuits = [(s, e) for name, s, e in trace.host
                if name == "qtbench.circuit"]
    if not circuits:
        return None
    return min(s for s, _e in circuits), max(e for _s, e in circuits)


def window_spans(trace: TR.Trace, name: str, records=None) -> list:
    """The records named ``name`` that lie inside the traced window
    (``records``: the program's span ring where not given)."""
    w = window(trace)
    if w is None:
        return []
    lo = int((w[0] - SLACK_S) * 1e9)
    hi = int((w[1] + SLACK_S) * 1e9)
    if records is None:
        records = program_spans(lo)
    return [r for r in records if r["name"] == name
            and r["start_ns"] >= lo and r["end_ns"] <= hi]


def idle_within(trace: TR.Trace, records: list) -> float:
    """Seconds in which the card idled inside the records' intervals
    (their union, less every busy interval of the card):
    ``trace.idle_within`` over a trace that holds the records as its host
    regions."""
    region = "span"
    host = [(region, r["start_ns"] * 1e-9, r["end_ns"] * 1e-9)
            for r in records]
    return TR.idle_within(TR.Trace(device=trace.device, host=host,
                                   window_s=trace.window_s), region)


def idle_ms_per_circuit(ctx, name: str):
    """Milliseconds per circuit (a bank element counts as one) in which
    the card idles inside the program's ``name`` spans, over the traced
    window; None where the window holds none."""
    records = window_spans(ctx.trace, name)
    if not records or not ctx.circuits:
        return None
    return idle_within(ctx.trace, records) / ctx.circuits * 1e3
