"""The comparison that decides ``correct`` fails what it must, at a tiny
size on the CPU: each cell's control (the program's "bf16_3x" mode, the
nearest below the configurations' "highest", or the reference in TF32
where the program's path has no lower mode), and the timed path broken
underneath in each way the cell can be: a step that returns its state
unchanged, half of a bank left out, and an answer altered where it is
produced.  The faults of a register split over shards (an exchange left
out, one shard's state off) are ``test_harness.py``'s."""

import time

import pytest
import torch

from quest_tpu_torch import circuit, fusion
from qtbench import harness

SPEC = harness.load_json(harness.ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in SPEC["workloads"]]
SEED = 2 ** 31 + 1234


def run(cell, tiny, control=False):
    config = harness.load_cell(cell)[1]["config"]
    result, readings = harness.run_cell(
        cell, SEED, 0.2, False, t_start=time.perf_counter(), device="cpu",
        overrides=tiny[config], control=control)
    return result, readings


@pytest.fixture(autouse=True)
def plans(monkeypatch, tmp_path):
    monkeypatch.setenv("QT_AOT_CACHE", str(tmp_path))
    fusion.clear_plan_caches()
    yield
    fusion.clear_plan_caches()


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell, tiny):
    assert run(cell, tiny)[0]["correct"] is True


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell, tiny):
    result, readings = run(cell, tiny, control=True)
    assert result["correct"] is False, readings


def _unchanged_state(monkeypatch, cell):
    _spec, _entry, cfg, traffic, _file = harness.load_cell(cell)
    if cfg["circuit"] == "qft" and "route" not in traffic:
        monkeypatch.setattr(circuit, "fused_qft",
                            lambda amps, *a, **k: amps)
    else:
        monkeypatch.setattr(fusion, "execute_program",
                            lambda amps, *a, **k: amps)


@pytest.mark.parametrize("cell", CELLS)
def test_step_returning_its_state_unchanged(cell, tiny, monkeypatch):
    _unchanged_state(monkeypatch, cell)
    assert run(cell, tiny)[0]["correct"] is False


@pytest.mark.parametrize(
    "cell", [c for c in CELLS if harness.load_cell(c)[3]["batch"]])
def test_half_the_bank_left_out(cell, tiny, monkeypatch):
    real = fusion.execute_program

    def half(amps, program, probs, n, release=None, stage=None):
        h = amps.shape[0] // 2
        done = real(amps[:h].contiguous(), program, probs, n)
        return torch.cat([done, amps[h:]])

    monkeypatch.setattr(fusion, "execute_program", half)
    assert run(cell, tiny)[0]["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_answer_altered_where_produced(cell, tiny, monkeypatch):
    """Every cell compares its final state alone (its read-outs have no
    upper reading): one amplitude negated where the circuit's last step
    writes it, the drain's program or the fused QFT."""
    cfg = harness.load_cell(cell)[2]
    owner, name = ((circuit, "fused_qft") if cfg["circuit"] == "qft"
                   else (fusion, "execute_program"))
    real = getattr(owner, name)

    def altered(amps, *a, **k):
        out = real(amps, *a, **k)
        out[..., 0] = -out[..., 0]
        return out

    monkeypatch.setattr(owner, name, altered)
    assert run(cell, tiny)[0]["correct"] is False
