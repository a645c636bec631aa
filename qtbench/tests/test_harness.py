"""The harness end to end on the port at a tiny size on the CPU: every
configuration, cell, traffic and metric file is found by name, and the
last line of a run holds the contract's keys alone."""

import io
import json
import re
import time
from contextlib import redirect_stdout

import pytest
import torch

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
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    # at most a quarter of the cells, rounded down, on four chips, or one
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
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


# ---------------------------------------------------------------------------
# a register split over shards, and the names a cell's files may give
# ---------------------------------------------------------------------------

SEED = 2 ** 31 + 2424


@pytest.fixture
def plans(monkeypatch, tmp_path):
    from quest_tpu_torch import fusion

    monkeypatch.setenv("QT_AOT_CACHE", str(tmp_path))
    fusion.clear_plan_caches()
    yield
    fusion.clear_plan_caches()


def _cpu_run(cell, overrides, **kw):
    return harness.run_cell(cell, SEED, 0.2, False,
                            t_start=time.perf_counter(), device="cpu",
                            overrides=overrides, **kw)


def test_split_register_reads_as_one(tiny, plans):
    """rc26.api at the tiny size on four shards is correct, and its
    error is of the unsplit run's size at the same seed."""
    whole, whole_err = _cpu_run("rc26.api", tiny["rc26"])
    split, split_err = _cpu_run("rc26.api", tiny["rc26"],
                                devices=["cpu"] * 4)
    assert whole["correct"] is True and split["correct"] is True
    assert whole_err["state_err"] / 2 <= split_err["state_err"] \
        <= 2 * whole_err["state_err"]


def _perturbed_shard(monkeypatch):
    from quest_tpu_torch import fusion

    real = fusion.execute_sharded_program

    def perturbed(amps, *a, **k):
        out = real(amps, *a, **k)
        out.shards[1].mul_(1.0 + 1e-3)
        return out

    monkeypatch.setattr(fusion, "execute_sharded_program", perturbed)


def _exchange_left_out(monkeypatch):
    from quest_tpu_torch.parallel import mesh

    def permute(self, sends, pairs):
        out = [None] * len(self.devices)
        for _src, dst in pairs:
            out[dst] = sends[dst].to(self.devices[dst], copy=True)
        return out

    monkeypatch.setattr(mesh.InProcessMesh, "permute", permute)
    monkeypatch.setattr(mesh.InProcessMesh, "all_to_all",
                        lambda self, blocks: [b.clone() for b in blocks])


@pytest.mark.parametrize("fault", ["perturbed_shard", "exchange_left_out",
                                   "control"])
def test_split_register_faults(fault, monkeypatch, plans):
    """Four shards at 16 qubits (14 local bits: the drain's window passes
    run, and with them the control's lower matmul mode; at 15 qubits the
    shards are too small for a window and the mode acts on nothing): one
    shard's final state off by 1e-3, the exchanges between shards left
    out, and the cell's control each read ``correct`` false."""
    if fault == "perturbed_shard":
        _perturbed_shard(monkeypatch)
    elif fault == "exchange_left_out":
        _exchange_left_out(monkeypatch)
    result, readings = _cpu_run("rc26.api", {"num_qubits": 16},
                                devices=["cpu"] * 4,
                                control=fault == "control")
    assert result["correct"] is False, readings


def test_density_register_kind(plans):
    import quest_tpu_torch as qt

    _spec, _entry, cfg, traffic, _file = harness.load_cell(
        "rc26.api", {"num_qubits": 5, "register": "density"})
    cell = harness.Cell(qt, torch, cfg, traffic, SEED, "cpu", "highest")
    assert cell.q.is_density_matrix and cell.state_qubits == 10
    cell.run_once()
    assert cell.final_states()[0][0][1].shape == (2, 1 << 10)


def test_missing_reference_fails_at_set_up(plans):
    with pytest.raises(FileNotFoundError, match="qtbench/reference/nosuch.py"):
        _cpu_run("rc26.api", {"num_qubits": 8, "reference": "nosuch"})


def test_fresh_calls_draw_each_circuit_and_compare_the_last(tiny, plans,
                                                            monkeypatch):
    import quest_tpu_torch as qt

    _spec, _entry, cfg, traffic, _file = harness.load_cell(
        "rc26.api", tiny["rc26"])
    cell = harness.Cell(qt, torch, cfg, dict(traffic, calls="fresh"), SEED,
                        "cpu", "highest")
    first = cell.calls
    cell.next_circuit()
    assert cell.drawn == 1 and cell.calls[0][0] == "unitary"
    assert not (first[0][1][1] == cell.calls[0][1][1]).all()

    seen = {}
    real = harness.compare

    def compare(torch_, cell_, reads, finals, tf32_control):
        seen["drawn"] = cell_.drawn
        fresh = cell_.circuit.register_calls(cfg, [SEED, cell_.drawn])
        seen["last"] = all((a[1][1] == b[1][1]).all()
                           for a, b in zip(cell_.calls, fresh)
                           if a[0] == "unitary")
        return real(torch_, cell_, reads, finals, tf32_control)

    monkeypatch.setattr(harness, "compare", compare)
    result, _readings = _cpu_run("rc26.api", tiny["rc26"],
                                 traffic_overrides={"calls": "fresh"})
    assert result["correct"] is True
    assert seen["drawn"] >= 2 and seen["last"]
