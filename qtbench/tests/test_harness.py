"""The harness end to end on the port at a tiny size on the CPU: every
configuration, cell, traffic and metric file is found by name, and the
last line of a run holds the contract's keys alone."""

import io
import json
import re
from contextlib import redirect_stdout

import pytest

from qtbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_benchmark_json_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["qtbench"]
    assert [m["name"] for m in SPEC["end_to_end"]] == [
        "circuits_per_s", "circuit_p95_ms", "peak_mem_gib", "setup_s"]
    names = []
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[kind]:
            assert NAME.match(e["name"]), e["name"]
            names.append(e["name"])
    assert len(names) == len(set(names))
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for w in SPEC["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert 1 <= SPEC["run_seconds"] <= 51


@pytest.mark.parametrize("cell", CELLS)
def test_files_found_by_name(cell):
    _spec, entry, cfg, traffic, cell_file = harness.load_cell(cell)
    assert (harness.BENCH / "circuits" / f"{cfg['circuit']}.py").exists()
    assert set(cell_file) == {"limits", "control"}
    assert traffic["loop"] == "closed" and traffic["clients"] == 1
    for m in harness.cell_metrics(SPEC, "per_layer", cell):
        reader = harness.load_module(
            harness.BENCH / "metrics" / f"{m['name']}.py")
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES,
                reader.SOURCE) == (m["layer"], m["unit"], m["better"],
                                   m["moves"], m["source"])
        moved = [e for e in SPEC["end_to_end"] if e["name"] == m["moves"]]
        assert moved and ("workloads" not in moved[0]
                          or cell in moved[0]["workloads"])


def _run(cell, trace, tiny, monkeypatch, plans):
    """run.py's main on the CPU: the look for a card skipped, the run at
    the tiny size."""
    from qtbench import run as cli

    config = harness.load_cell(cell)[1]["config"]
    real = harness.run_cell
    monkeypatch.setattr(cli, "cards_visible", lambda: 1)
    monkeypatch.setattr(cli, "power_limit", lambda: "cpu")
    monkeypatch.setattr(harness, "set_cache_dirs",
                        lambda: monkeypatch.setenv("QT_AOT_CACHE", plans))
    monkeypatch.setattr(
        harness, "run_cell",
        lambda *a, **k: real(*a, **k, device="cpu",
                             overrides=tiny[config]))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["--workload", cell, "--seed", str(2 ** 31 + 11),
                       "--seconds", "0.3", "--trace", str(trace)])
    assert rc == 0
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, trace, tiny, monkeypatch, tmp_path):
    res = _run(cell, trace, tiny, monkeypatch, str(tmp_path))
    keys = list(res)
    want = RESULT_KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert keys == want
    assert res["correct"] is True and res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in harness.cell_metrics(SPEC, kind, cell)}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == allowed
    for name, c in res["checks"].items():
        assert set(c) == {"value", "limit"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])
    if trace:
        assert {"busy_s", "window_s"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_result_without_a_card(monkeypatch, capsys):
    from qtbench import run as cli

    monkeypatch.setattr(cli, "cards_visible", lambda: 0)
    rc = cli.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"])
    assert rc != 0 and capsys.readouterr().out == ""


def test_idle_within_a_region_is_its_span_less_busy_time():
    from qtbench import trace as TR

    ev = TR.DeviceEvent
    tr = TR.Trace(device=[ev("k", 1.0, 2.0), ev("k", 1.5, 3.0),
                          ev("k", 4.5, 5.5), ev("k", 9.0, 9.5)],
                  host=[("fusion.drain", 0.0, 4.0),
                        ("fusion.drain", 5.0, 6.0),
                        ("qtbench.gate_calls", 6.0, 9.0)],
                  window_s=10.0)
    # drain [0, 4] less busy [1, 3]: 2 s; [5, 6] less [4.5, 5.5]: 0.5 s
    assert TR.idle_within(tr, "fusion.drain") == pytest.approx(2.5)
    assert TR.idle_within(tr, "qtbench.gate_calls") == pytest.approx(3.0)
    assert TR.busy_s(tr) == pytest.approx(3.5)
