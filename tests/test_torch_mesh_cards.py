"""A register split over several cards (the in-process mesh): every
kernel launch runs with its tensor's card current, the sharded drain's
remaps and exchanges are spanned and their bytes agree with the exchange
counters, and the split random circuit equals the plain reference.

On the CPU the mesh is ``devices=["cpu"] * R``; the card's side of the
launch guard is held with ``torch.cuda``'s device and stream calls
replaced (``build.launch_stream``), and an AST walk holds every kernel
launch of ``ops/`` to it.  The four-card run itself is
``qtbench/tests/test_mesh4.py``'s card test.
"""

import ast
import math
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

import quest_tpu_torch as tq
from quest_tpu_torch import fusion
from quest_tpu_torch import telemetry as T
from quest_tpu_torch.ops import build
from quest_tpu_torch.parallel import dist as D
from qtbench.circuits import random_layers
from qtbench.reference import statevec as SV

OPS = Path(tq.__file__).resolve().parent / "ops"
SEED = 2 ** 31 + 25


@pytest.fixture
def fresh():
    prev = T.mode_name()
    T.configure("on")
    T.reset()
    fusion.clear_plan_caches()
    yield
    fusion.clear_plan_caches()
    T.configure(prev)


def _split_circuit(n, shards, precision):
    tq.set_precision(precision)
    q = tq.createQureg(n, tq.createQuESTEnv(devices=["cpu"] * shards))
    tq.initZeroState(q)
    calls = random_layers.register_calls({"num_qubits": n, "depth": 20},
                                         SEED)
    with tq.gateFusion(q):
        for name, args in calls:
            getattr(tq, name)(q, *args)
    return q, calls


def test_split_random_circuit_equals_the_reference(fresh):
    """The random circuit at 16 qubits, depth 20, through the API under
    gateFusion on four CPU shards at float64: within 1e-10 of the chunked
    plain reference, shard against chunk."""
    q, calls = _split_circuit(16, 4, 2)
    try:
        shards = q.amps.shards      # in canonical order
        ref = SV.initial_chunks(16, ["cpu"] * 4, torch.complex128)
        SV.apply_calls(ref, calls)
        num = den = 0.0
        for sh, r in zip(shards, ref, strict=True):
            got = torch.complex(sh[0].double(), sh[1].double())
            num += float(torch.sum(torch.abs(got - r) ** 2))
            den += float(torch.sum(torch.abs(r) ** 2))
        assert math.sqrt(num / den) <= 1e-10
        assert tq.calcProbOfOutcome(q, 15, 0) == pytest.approx(
            SV.readout(ref, "calcProbOfOutcome", (15, 0)), abs=1e-10)
    finally:
        tq.set_precision(1)


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_remap_and_exchange_spans(shards, fresh):
    """Each window remap of a drain is one ``mesh.remap`` span inside its
    ``fusion.dispatch``, carrying the drain's id; each of its exchanges one
    ``mesh.exchange`` inside it; the remaps' ``bytes`` add up to the
    drain's exchange_bytes_total{op="window_remap"}, and the exchanges'
    to the half shards their swaps move."""
    before = T.counter_sum("exchange_bytes_total", op="window_remap")
    t0 = T.now_ns()
    q, _calls = _split_circuit(16, shards, 1)
    moved = T.counter_sum("exchange_bytes_total", op="window_remap") - before
    recs = T.spans(t0)
    dispatch = {r["id"]: r for r in recs if r["name"] == "fusion.dispatch"}
    remaps = [r for r in recs if r["name"] == "mesh.remap"]
    exchanges = [r for r in recs if r["name"] == "mesh.exchange"]
    assert remaps and moved > 0
    assert sum(r["attrs"]["bytes"] for r in remaps) == moved
    for r in remaps:
        assert r["parent"] in dispatch
        assert r["attrs"]["drain"] == dispatch[r["parent"]]["attrs"]["drain"]
        assert set(r["attrs"]) == {"drain", "bytes", "swaps", "local",
                                   "tier"}
        assert r["attrs"]["tier"] == "ici" and r["attrs"]["swaps"] >= 1
    ids = {r["id"]: r for r in remaps}
    assert all(e["parent"] in ids for e in exchanges)
    half = (1 << (16 - (shards.bit_length() - 1))) * 4
    assert len(exchanges) == sum(r["attrs"]["swaps"] for r in remaps)
    assert all(e["attrs"] == {"bytes": half, "chunks": 1} for e in exchanges)
    assert sum(r["attrs"]["bytes"] for r in remaps) == half * len(exchanges)
    tq.destroyQureg(q, q.env)


def test_no_spans_when_telemetry_is_off(fresh):
    T.configure("off")
    t0 = T.now_ns()
    q, _calls = _split_circuit(16, 4, 1)
    assert q.is_sharded and T.spans(t0) == []


def test_settle_waits_for_each_card_only_under_the_profiler(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    cards = [torch.device("cuda", i) for i in (0, 1, 0, 1)]
    mesh = SimpleNamespace(devices=tuple(cards) + (torch.device("cpu"),))
    D.settle_traced(mesh)
    assert seen == []
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    D.settle_traced(mesh)
    assert sorted(seen, key=lambda d: d.index) == cards[:2]


def test_launch_stream_makes_the_tensors_card_current(monkeypatch):
    """``build.launch_stream`` enters the tensor's card as the current
    device around the launch and yields that card's stream."""
    entered = []

    class Guard:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(("in", self.device))

        def __exit__(self, *exc):
            entered.append(("out", self.device))

    monkeypatch.setattr(torch.cuda, "device", Guard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: SimpleNamespace(cuda_stream=100
                                                    + dev.index))
    t = SimpleNamespace(device=torch.device("cuda", 2))
    with build.launch_stream(t) as stream:
        assert stream == 102 and entered == [("in", t.device)]
    assert entered[-1] == ("out", t.device)


def _launches(tree):
    """(line, whether it lies in a ``with build.launch_stream(...)``) of
    each ``build.raise_on`` call that passes a stream."""
    out = []

    def walk(node, guarded):
        if isinstance(node, ast.With):
            guarded = guarded or any(
                isinstance(it.context_expr, ast.Call)
                and getattr(it.context_expr.func, "attr", "")
                == "launch_stream" for it in node.items)
        if (isinstance(node, ast.Call)
                and getattr(node.func, "attr", "") == "raise_on"
                and any(isinstance(n, ast.Name) and n.id == "stream"
                        for n in ast.walk(node))):
            out.append((node.lineno, guarded))
        for child in ast.iter_child_nodes(node):
            walk(child, guarded)

    walk(tree, False)
    return out


def test_every_launch_runs_under_its_tensors_card():
    """Every kernel launch of ``ops/`` that passes a stream lies inside
    ``build.launch_stream``, and no stream is read anywhere else."""
    launches = {}
    for path in sorted(OPS.glob("*.py")):
        src = path.read_text()
        if path.name != "build.py":
            assert "cuda_stream" not in src, path.name
        launches[path.name] = _launches(ast.parse(src))
    flat = [(name, line) for name, ls in launches.items()
            for line, guarded in ls if not guarded]
    assert flat == []
    assert {k: len(v) for k, v in launches.items() if v} == {
        "bigstate.py": 1, "fused.py": 5, "paulis.py": 2, "stream.py": 1}
