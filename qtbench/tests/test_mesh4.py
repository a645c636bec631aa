"""The four-card cell ``rc33.mesh4``: its files and shape, its metric
readers on a synthetic trace of four cards, the faster reference it names
against ``statevec``, its run's last line on four CPU shards, and, on a
host with four cards, the split register on four cards against the same
register on four shards of one card, bit for bit."""

import io
import json
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from qtbench import harness
from qtbench import roofline as RF
from qtbench import spans as SP
from qtbench import trace as TR
from qtbench.circuits import random_layers
from qtbench.reference import statevec as SV
from qtbench.reference import statevec_grouped as SG

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELL = "rc33.mesh4"
METRICS = ("remap_share", "exchange_roofline", "shard_window_roofline",
           "card_idle_share_max")


def test_cell_files_and_shape():
    _spec, entry, cfg, traffic, cell_file = harness.load_cell(CELL)
    assert entry["chips"] == 4 and entry["config"] == "rc33"
    assert (cfg["circuit"], cfg["num_qubits"], cfg["depth"]) == (
        "random_layers", 33, 20)
    assert len(random_layers.register_calls(cfg, 1)) == cfg["gates"] == 980
    assert cell_file["limits"] == {"state_err": 1.5e-05}
    assert cell_file["control"]["matmul_precision"] == "bf16_3x"
    assert traffic["batch"] == 0
    # at most a quarter of the cells, rounded down, on four chips, or one
    four = [w["name"] for w in SPEC["workloads"] if w["chips"] == 4]
    assert CELL in four
    assert len(four) <= max(1, len(SPEC["workloads"]) // 4)
    names = [m["name"] for m in harness.cell_metrics(SPEC, "per_layer",
                                                     CELL)]
    assert names == list(METRICS)
    harness.load_reference(cfg["reference"]).check(
        random_layers.register_calls(cfg, 1), "calcProbOfOutcome", 4)


# ---------------------------------------------------------------------------
# the readers on four cards
# ---------------------------------------------------------------------------


def _ev(name, start, end, card):
    return TR.DeviceEvent(name, start, end, card)


def _rec(name, start, end, **attrs):
    return {"name": name, "start_ns": int(start * 1e9),
            "end_ns": int(end * 1e9), "id": 1, "parent": None, "tid": 0,
            "attrs": attrs}


K1 = "void window_pass_kernel<float, 0>(float const*, float*)"
COPY = "void at::native::elementwise_kernel<128, 4>(int)"
HALF = int(0.25 * 450e9)       # bytes a card sends in 0.25 s of link


def _four_cards(monkeypatch):
    """A 10 s window on four cards.  Each card runs two K1 launches of
    0.5 s ([1, 1.5], [2, 2.5]) and a remap in [5, 7], inside which an
    exchange in [5, 6]: each card is busy 0.5 s in the exchange and 0.25
    s more in the remap (card 3 busy 0.5 s less, at [8, 8.5] missing)."""
    device, host = [], [("qtbench.circuit", 0.0, 10.0)]
    for c in range(4):
        device += [_ev(K1, 1.0, 1.5, c), _ev(K1, 2.0, 2.5, c),
                   _ev(COPY, 5.0, 5.5, c), _ev(COPY, 6.25, 6.5, c)]
        if c != 3:
            device.append(_ev(COPY, 8.0, 8.5, c))
    records = [_rec("mesh.remap", 5.0, 7.0, bytes=HALF, swaps=1,
                    local=False, tier="ici"),
               _rec("mesh.exchange", 5.0, 6.0, bytes=HALF, chunks=8)]
    monkeypatch.setattr(SP, "program_spans", lambda since=0: [
        r for r in records if r["start_ns"] >= since])
    trace = TR.Trace(device=sorted(device, key=lambda e: e.start),
                     host=host, window_s=10.0)
    cost = RF.window_pass_cost(1, 2, False, 1 << 20)
    return SimpleNamespace(trace=trace, circuits=1, drains=1, shards=4,
                           window_costs=[cost, cost], num_amps=1 << 20,
                           log=lambda msg: None)


def _reader(name):
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py")


def test_readers_on_four_cards(monkeypatch):
    ctx = _four_cards(monkeypatch)
    busy = 3 * 2.25 + 1.75
    assert _reader("remap_share").read(ctx) == pytest.approx(
        100.0 * 4 * 0.75 / busy)
    # each card sends HALF bytes (0.25 s of link) in 0.5 s of device time
    assert _reader("exchange_roofline").read(ctx) == pytest.approx(50.0)
    assert _reader("card_idle_share_max").read(ctx) == pytest.approx(82.5)
    # two passes on each of four shards, 8 launches of 0.5 s
    least = RF.least_s(*ctx.window_costs[0])
    assert _reader("shard_window_roofline").read(ctx) == pytest.approx(
        100.0 * 8 * least / 4.0)


def test_readers_find_nothing_on_a_parent_without_the_spans(monkeypatch):
    ctx = _four_cards(monkeypatch)
    monkeypatch.setattr(SP, "program_spans", lambda since=0: [])
    assert _reader("remap_share").read(ctx) is None
    assert _reader("exchange_roofline").read(ctx) is None


def test_readers_on_one_card(monkeypatch):
    """Four shards on one card: the exchanges cross no link, and the
    window passes of a register held whole are window_roofline's."""
    ctx = _four_cards(monkeypatch)
    ctx.trace.device = [e for e in ctx.trace.device if e.card == 0]
    assert _reader("exchange_roofline").read(ctx) is None
    assert _reader("card_idle_share_max").read(ctx) == pytest.approx(77.5)
    ctx.shards = 1
    assert _reader("shard_window_roofline").read(ctx) is None


def test_shard_window_roofline_falls_back_to_bytes(monkeypatch):
    ctx = _four_cards(monkeypatch)
    ctx.drains = 2
    bytes_only = RF.state_pass_bytes(1 << 20) / RF.HBM_BYTES_PER_S
    assert _reader("shard_window_roofline").read(ctx) == pytest.approx(
        100.0 * 8 * bytes_only / 4.0)


# ---------------------------------------------------------------------------
# the faster reference against statevec
# ---------------------------------------------------------------------------


def _extra_calls(n):
    return [("hadamard", (n - 1,)), ("swapGate", (0, n - 1)),
            ("controlledPhaseShift", (1, n - 2, 0.7)),
            ("swapGate", (2, 5)), ("controlledPhaseShift", (n - 1, 0, -0.3)),
            ("controlledNot", (n - 1, 3))] * 2


@pytest.mark.parametrize("n,chunks,block", [(12, 1, 1 << 24), (12, 4, 1 << 6),
                                            (14, 4, 1 << 24), (16, 4, 1 << 10),
                                            (13, 2, 1 << 4)])
def test_grouped_reference_equals_statevec(n, chunks, block, monkeypatch):
    """The random circuit and every other call the grouped reference
    takes, in one chunk and in several, with blocks small enough that
    runs span blocks and chunks: within 1e-12 of statevec."""
    monkeypatch.setattr(SV, "BLOCK", block)
    monkeypatch.setattr(SG, "BLOCK_BITS", block.bit_length() - 1)
    calls = random_layers.register_calls(
        {"num_qubits": n, "depth": 20}, 2 ** 31 + n) + _extra_calls(n)
    a = SV.initial_chunks(n, ["cpu"] * chunks, torch.complex128)
    b = SV.initial_chunks(n, ["cpu"] * chunks, torch.complex128)
    SV.apply_calls(a if chunks > 1 else a[0], calls)
    SG.apply_calls(b if chunks > 1 else b[0], calls)
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    assert err <= 1e-12
    assert SG.readout(b, "calcProbOfOutcome", (n - 1, 0)) == pytest.approx(
        SV.readout(a, "calcProbOfOutcome", (n - 1, 0)), abs=1e-12)


def test_grouped_runs_keep_their_bounds():
    calls = random_layers.register_calls({"num_qubits": 33, "depth": 20}, 3)
    runs = SG.runs(calls, SG.BLOCK_BITS)
    assert sum(len(SG.gate(*c)[0]) for c in calls) == 1300
    assert all(len(q) <= SG.K and sum(x >= SG.BLOCK_BITS for x in q)
               <= SG.HIGH for q, _op in runs)
    assert len(runs) < len(calls) // 3
    for _q, op in runs:
        assert abs(op @ op.conj().T - torch.eye(len(op)).numpy()).max() \
            < 1e-12


def test_grouped_reference_refuses_what_it_lacks():
    with pytest.raises(NotImplementedError, match="applyFullQFT"):
        SG.check([("applyFullQFT", ())], "calcProbOfOutcome", 1)
    with pytest.raises(NotImplementedError, match="TF32"):
        SG.apply_calls(torch.zeros(4, dtype=torch.complex64),
                       [("hadamard", (0,))], tf32=True)


# ---------------------------------------------------------------------------
# a run of the cell
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_on_four_cpu_shards(trace, monkeypatch, tmp_path):
    """run.py's main on the CPU with the register on four CPU shards at
    16 qubits: the contract's keys, correct."""
    from qtbench import run as cli

    real = harness.run_cell
    monkeypatch.setattr(cli, "cards_visible", lambda: 4)
    monkeypatch.setattr(cli, "power_limit", lambda: "cpu")
    monkeypatch.setattr(harness, "set_cache_dirs",
                        lambda: monkeypatch.setenv("QT_AOT_CACHE",
                                                   str(tmp_path)))
    monkeypatch.setattr(
        harness, "run_cell",
        lambda *a, **k: real(*a, **k, device="cpu", devices=["cpu"] * 4,
                             overrides={"num_qubits": 16}))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["--workload", CELL, "--seed", str(2 ** 31 + 25),
                       "--seconds", "0.2", "--trace", str(trace)])
    assert rc == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True and res["failed"] == 0
    kind = "per_layer" if trace else "end_to_end"
    allowed = {m["name"] for m in harness.cell_metrics(SPEC, kind, CELL)}
    assert set(res["metrics"]) <= allowed
    if not trace:
        assert set(res["metrics"]) == {"circuits_per_s", "peak_mem_gib",
                                       "setup_s"}


def _broken(fault, monkeypatch):
    """The timed path broken as ``test_faults.py`` breaks it: each shard's
    step returning its state unchanged, or an amplitude of each shard's
    output negated where the drain's program writes it."""
    from quest_tpu_torch import fusion

    real = fusion.execute_program

    def altered(amps, *a, **k):
        out = real(amps, *a, **k)
        out[..., 0] = -out[..., 0]
        return out

    fn = altered if fault == "altered" else (lambda amps, *a, **k: amps)
    monkeypatch.setattr(fusion, "execute_program", fn)


@pytest.mark.parametrize("fault", ["none", "control", "unchanged",
                                   "altered"])
def test_faults_on_four_cpu_shards(fault, monkeypatch, tmp_path):
    """The cell at 16 qubits on four CPU shards: correct when sound, and
    not under its control or with the timed path broken."""
    from quest_tpu_torch import fusion

    monkeypatch.setenv("QT_AOT_CACHE", str(tmp_path))
    fusion.clear_plan_caches()
    if fault in ("unchanged", "altered"):
        _broken(fault, monkeypatch)
    result, readings = harness.run_cell(
        CELL, 2 ** 31 + 2526, 0.2, False, t_start=time.perf_counter(),
        device="cpu", devices=["cpu"] * 4, overrides={"num_qubits": 16},
        control=fault == "control")
    fusion.clear_plan_caches()
    assert result["correct"] is (fault == "none"), readings


# ---------------------------------------------------------------------------
# on four cards
# ---------------------------------------------------------------------------


def _split_run(devices, n, seed):
    import quest_tpu_torch as qt

    qt.set_precision(1)
    env = qt.createQuESTEnv(devices=devices)
    q = qt.createQureg(n, env)
    qt.initZeroState(q)
    with qt.gateFusion(q):
        for name, args in random_layers.register_calls(
                {"num_qubits": n, "depth": 20}, seed):
            getattr(qt, name)(q, *args)
    prob = qt.calcProbOfOutcome(q, n - 1, 0)
    shards = [s.cpu() for s in q.amps.shards]
    assert [s.device for s in q.amps.shards] == list(env.devices)
    return shards, prob


@pytest.mark.card
def test_four_cards_equal_four_shards_of_one(card):
    """24 qubits split over cuda:0..3 through the API under gateFusion
    equal the same circuit split four ways on cuda:0, bit for bit: every
    kernel launches on its shard's own card, and a peer copy moves the
    same bits as a copy on one card."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs four CUDA cards; "
                    f"{torch.cuda.device_count()} visible")
    harness.set_cache_dirs()
    from quest_tpu_torch.ops import build

    build.build_kernels()
    seed = 2 ** 31 + 2525
    t0 = time.perf_counter()
    split, p_split = _split_run([f"cuda:{i}" for i in range(4)], 24, seed)
    one, p_one = _split_run(["cuda:0"] * 4, 24, seed)
    assert all(torch.equal(a, b) for a, b in zip(split, one))
    assert p_split == p_one
    assert time.perf_counter() - t0 < 300
