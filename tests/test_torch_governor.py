"""The memory governor (M16c) in the port against the JAX package.

The classes of tests/test_governor.py, each held against the reference
under the same QT_HBM_BUDGET_BYTES / QT_MEM_POLICY: every admit and
refuse decision with its error's predicted, available and budget bytes;
explain_circuit's memory section field by field (all but
pass_array_bytes, the port's own plan operands, and the fields that add
it in); the ladder's rungs, chunk count and group count; spill and
restore bit for bit, with a bank's key bank and a live permutation.
Registers of 13 qubits on in-process CPU meshes of 8 shards (16 KiB of
float64 per shard), the reference on the suite's 8-device mesh; the OOM
net, the per-card budget and the failed probe are the port's own.
"""

import warnings
import weakref

import numpy as np
import pytest
import torch

import quest_tpu as qt
from quest_tpu import governor as RG
from quest_tpu import resilience as RR
from quest_tpu import telemetry as RT
from quest_tpu.parallel import dist as RD
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import governor as G
from quest_tpu_torch import interop, precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import telemetry as T
from quest_tpu_torch.parallel import dist as PD
from quest_tpu_torch.utils import profiling

U2 = np.linalg.qr(np.random.default_rng(11).normal(size=(4, 4)))[0]
U2_SOA = np.stack([U2, np.zeros_like(U2)])

NBIG = 13  # 16 KiB per shard on 8 shards (float64)
STATE = 16384

# the memory section's fields the port holds to the reference (the rest
# add the pass arrays in)
SAME_FIELDS = ("policy", "budget_bytes", "state_bytes_per_device",
               "live_multiplier", "exchange_chunks", "other_resident_bytes",
               "fits", "exchange_tier_bytes", "weighted_exchange_cost")


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    """Both governors empty, no budget, the default policy, no chunk
    override, telemetry on, float64 in the port; the degradation
    registries and measurement streams restored afterwards."""
    for var in ("QT_HBM_BUDGET_BYTES", "QT_MEM_POLICY", "QT_EXCHANGE_CHUNKS"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0.001")
    old = precision.get_precision()
    tq.set_precision(2)
    modes = (T.mode_name(), RT.mode_name())
    T.configure("on")
    RT.configure("on")
    G.reset()
    RG.reset()
    degr = (dict(PR.DEGRADATIONS), dict(RR.DEGRADATIONS))
    for reg in (PR.DEGRADATIONS, RR.DEGRADATIONS):
        for k in list(reg):
            if k.startswith("memory_governor"):
                reg.pop(k)
    yield
    G.reset()
    RG.reset()
    PR.DEGRADATIONS.clear()
    PR.DEGRADATIONS.update(degr[0])
    RR.DEGRADATIONS.clear()
    RR.DEGRADATIONS.update(degr[1])
    T.configure(modes[0])
    RT.configure(modes[1])
    tq.set_precision(old)


@pytest.fixture(scope="module")
def penv():
    return tq.createQuESTEnv(devices=["cpu"] * 8)


def host(q):
    return interop.register_state(q, canonical=True)[0]


def _big_workload(mod, q):
    """Two windows: a local gate, then a gate on the sharded top qubits
    (a remap)."""
    with mod.gateFusion(q):
        mod.multiQubitUnitary(q, [0, 1], U2)
        mod.multiQubitUnitary(q, [NBIG - 2, NBIG - 1], U2)


def _predict(mod, gov, env, monkeypatch):
    """The unconstrained memory section of _big_workload and its final
    state in package ``mod``."""
    monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 40))
    gov.reset()
    q = mod.createQureg(NBIG, env)
    with mod.gateFusion(q):
        mod.multiQubitUnitary(q, [0, 1], U2)
        mod.multiQubitUnitary(q, [NBIG - 2, NBIG - 1], U2)
        mem = mod.explain_circuit(q)["memory"]
    amps = host(q) if mod is tq else np.asarray(q.amps)
    mod.destroyQureg(q, env)
    monkeypatch.delenv("QT_HBM_BUDGET_BYTES")
    gov.reset()
    return mem, amps


@pytest.fixture
def both(env, penv):
    """(reference env, port env): 8 shards each."""
    return env, penv


def _refusal(fn):
    with pytest.raises(Exception) as ei:
        fn()
    e = ei.value
    assert type(e).__name__ == "MemoryAdmissionError", e
    return e


def _numbers(e):
    return (e.predicted_bytes, e.available_bytes, e.budget_bytes)


# ---------------------------------------------------------------------------
# Admission
# ---------------------------------------------------------------------------


class TestAdmission:
    def test_within_budget_admits_and_tracks(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        for mod, gov, env in ((qt, RG, both[0]), (tq, G, both[1])):
            q = mod.createQureg(NBIG, env)
            assert gov.resident_bytes() == \
                gov.register_bytes_per_device(q) == STATE
            mod.destroyQureg(q, env)
            assert gov.resident_bytes() == 0

    def test_reject_math_and_error_attrs(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", "8192")
        rejects0 = T.counter_total("admission_rejects_total")
        errs = [_refusal(lambda m=mod, e=env: m.createQureg(NBIG, e))
                for mod, env in ((qt, both[0]), (tq, both[1]))]
        assert _numbers(errs[1]) == _numbers(errs[0]) == (STATE, 8192, 8192)
        assert str(errs[1]) == str(errs[0])
        assert isinstance(errs[1], tq.QuESTError)
        assert T.counter_value("admission_rejects_total",
                               func="createQureg") == rejects0 + 1

    def test_reject_accounts_for_resident_registers(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(STATE + 1024))
        for mod, env in ((qt, both[0]), (tq, both[1])):
            q1 = mod.createQureg(NBIG, env)
            e = _refusal(lambda: mod.createQureg(NBIG, env))
            assert _numbers(e) == (STATE, 1024, STATE + 1024)
            mod.destroyQureg(q1, env)
            q2 = mod.createQureg(NBIG, env)
            mod.destroyQureg(q2, env)

    def test_density_admission(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", "16384")
        errs = [_refusal(lambda m=mod, e=env: m.createDensityQureg(7, e))
                for mod, env in ((qt, both[0]), (tq, both[1]))]
        assert _numbers(errs[1]) == _numbers(errs[0])
        assert errs[1].predicted_bytes == 32768
        assert "createDensityQureg" in str(errs[1])

    def test_clone_admission(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(STATE + 1024))
        errs = []
        for mod, env in ((qt, both[0]), (tq, both[1])):
            q = mod.createQureg(NBIG, env)
            errs.append(_refusal(lambda: mod.createCloneQureg(q, env)))
            mod.destroyQureg(q, env)
        assert _numbers(errs[1]) == _numbers(errs[0]) == \
            (STATE, 1024, STATE + 1024)
        assert "createCloneQureg" in str(errs[1])

    def test_batched_admission_scales_with_batch(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(3 * STATE))
        errs = []
        for mod, gov, env in ((qt, RG, both[0]), (tq, G, both[1])):
            b = mod.createBatchedQureg(NBIG, env, 3)  # exactly fits
            assert gov.register_bytes_per_device(b) == 3 * STATE
            gov.release(b)
            errs.append(_refusal(
                lambda: mod.createBatchedQureg(NBIG, env, 4)))
        assert _numbers(errs[1]) == _numbers(errs[0])
        assert errs[1].predicted_bytes == 4 * STATE
        assert "createBatchedQureg" in str(errs[1])

    def test_no_budget_means_inert(self, penv):
        assert not G.enabled()
        assert G.budget_bytes(penv) is None  # a CPU device has no budget
        q = tq.createQureg(NBIG, penv)
        assert G.govern_drain(q, (("plan", ()),), nloc=10, nsh=3) is None
        tq.destroyQureg(q, penv)

    def test_policy_off_disables_even_with_budget(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", "64")
        monkeypatch.setenv("QT_MEM_POLICY", "off")
        for mod, env in ((qt, both[0]), (tq, both[1])):
            q = mod.createQureg(NBIG, env)
            mod.destroyQureg(q, env)

    def test_card_budget_is_shared_by_the_shards_on_a_card(self, monkeypatch):
        """On the card the budget is the probed bytes divided among the
        mesh's shards on that card: R in-process shards each get 1/R of
        it, a torch.distributed rank (one local shard) all of it."""

        class Mesh:
            def __init__(self, devices, local):
                self.devices, self.local = devices, local

        class Env:
            def __init__(self, devices, local):
                self.device = torch.device(devices[local[0]])
                self.mesh = Mesh(tuple(torch.device(d) for d in devices),
                                 local)

        limit = 80 << 30
        monkeypatch.setattr(G, "_limit", lambda d: limit)
        assert G.budget_bytes(Env(["cuda:0"] * 8, tuple(range(8)))) == \
            limit // 8
        assert G.budget_bytes(Env(["cuda:0"] * 4 + ["cuda:1"] * 4,
                                  tuple(range(8)))) == limit // 4
        assert G.budget_bytes(Env(["cuda:0"] * 8, (3,))) == limit
        assert G.budget_bytes(Env(["cpu"] * 8, tuple(range(8)))) is None
        # the override keeps the reference's per-mesh-device meaning
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", "4096")
        assert G.budget_bytes(Env(["cuda:0"] * 8, tuple(range(8)))) == 4096

    def test_a_failed_probe_on_a_card_raises(self, monkeypatch):
        """A CUDA device whose memory cannot be read raises: the governor
        never goes inert there."""
        def boom(_dev):
            raise RuntimeError("CUDA driver error: unknown error")

        monkeypatch.setattr(torch.cuda, "mem_get_info", boom)
        with pytest.raises(tq.QuESTError, match="cannot read the memory"):
            G._limit(torch.device("cuda", 0))
        monkeypatch.setattr(G, "_pieces", lambda x: {
            torch.device("cuda", 0): 8})
        with pytest.raises(tq.QuESTError, match="QT_HBM_BUDGET_BYTES"):
            G.enabled(object())


# ---------------------------------------------------------------------------
# Predictor
# ---------------------------------------------------------------------------


class TestPredictor:
    def test_explain_memory_section_matches_the_reference(self, both,
                                                          monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        mems = []
        for mod, env in ((qt, both[0]), (tq, both[1])):
            idle = mod.createQureg(9, env)  # resident beside the drain
            q = mod.createQureg(NBIG, env)
            with mod.gateFusion(q):
                mod.multiQubitUnitary(q, [0, 1], U2)
                mod.multiQubitUnitary(q, [NBIG - 2, NBIG - 1], U2)
                rep = mod.explain_circuit(q)
            mems.append(rep["memory"])
            if mod is tq:
                assert "memory:" in rep.table()
            mod.destroyQureg(q, env)
            mod.destroyQureg(idle, env)
        ref, got = mems
        assert set(got) == set(ref)
        assert {k: got[k] for k in SAME_FIELDS} == \
            {k: ref[k] for k in SAME_FIELDS}
        assert got["state_bytes_per_device"] == STATE
        assert got["other_resident_bytes"] == 2 * (1 << 9) * 8 // 8
        assert got["fits"] is True
        # the peak is the model's, with the port's own pass arrays
        assert got["pass_array_bytes"] > 0
        assert got["predicted_peak_bytes"] == int(
            STATE * got["live_multiplier"]) + got["pass_array_bytes"]
        assert got["predicted_total_bytes"] == (
            got["predicted_peak_bytes"] + got["other_resident_bytes"])

    def test_predictor_matches_measured_watermark(self, penv, monkeypatch):
        """explain_circuit's predicted peak within 10 % of the
        hbm_watermark_bytes{device=model} the drain records (the modeled
        watermark stands in for device statistics on the CPU)."""
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        q = tq.createQureg(NBIG, penv)
        with tq.gateFusion(q):
            tq.multiQubitUnitary(q, [0, 1], U2)
            tq.multiQubitUnitary(q, [NBIG - 2, NBIG - 1], U2)
            rep = tq.explain_circuit(q)
        predicted = rep["memory"]["predicted_total_bytes"]
        wm = profiling.memory_watermark()
        assert "model" in wm
        measured = wm["model"]["modeled_peak_bytes_in_use"]
        assert measured == G.modeled_watermark_bytes()
        assert abs(predicted - measured) <= 0.10 * measured
        assert T.snapshot()["gauges"]["hbm_watermark_bytes"][
            "device=model"] == measured
        tq.destroyQureg(q, penv)

    def test_explain_is_side_effect_free(self, penv, monkeypatch):
        """The memory section moves no counter and inserts nothing into
        the plan cache."""
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        q = tq.createQureg(NBIG, penv)
        PF._plan_cache.clear()
        with tq.gateFusion(q):
            tq.multiQubitUnitary(q, [0, 1], U2)
            tq.multiQubitUnitary(q, [NBIG - 2, NBIG - 1], U2)
            before = dict(T.snapshot().get("counters", {}))
            tq.explain_circuit(q)
            assert len(PF._plan_cache) == 0
            assert dict(T.snapshot().get("counters", {})) == before
        tq.destroyQureg(q, penv)


# ---------------------------------------------------------------------------
# Spill
# ---------------------------------------------------------------------------


class TestSpill:
    def test_spill_restore_amps_and_perm(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        rq = qt.createQureg(NBIG, both[0])
        _big_workload(qt, rq)
        r_perm = tuple(rq._perm) if rq._perm is not None else None
        r_freed = RG.spill_register(rq)
        q = tq.createQureg(NBIG, both[1])
        _big_workload(tq, q)
        q._amps_raw()
        perm0 = q._perm
        raw0 = [s.clone() for s in q._amps.shards]
        assert perm0 is not None and perm0 == r_perm
        spills0 = T.counter_total("spills_total")
        assert G.spill_register(q) == r_freed == STATE
        assert q._amps is None and q._spill is not None
        assert T.counter_total("spills_total") == spills0 + 1
        assert T.counter_total("spill_bytes_total") >= 2 * (1 << NBIG) * 8
        # the first raw touch restores the permuted shards bit for bit
        raw1 = q._amps_raw().shards
        assert all(torch.equal(a, b) for a, b in zip(raw0, raw1))
        assert q._perm == perm0
        assert T.counter_total("spill_restores_total") >= 1
        np.testing.assert_allclose(host(q), np.asarray(rq.amps), atol=1e-10)
        qt.destroyQureg(rq, both[0])
        tq.destroyQureg(q, both[1])

    def test_spill_frees_the_tensors(self, penv, monkeypatch):
        """Nothing keeps a spilled register's shard tensors alive (the
        plan and device-program caches hold no state)."""
        import gc

        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        q = tq.createQureg(NBIG, penv)
        _big_workload(tq, q)
        refs = [weakref.ref(s) for s in q._amps_raw().shards]
        G.spill_register(q)
        gc.collect()
        assert all(r() is None for r in refs)
        tq.destroyQureg(q, penv)

    def test_spill_preserves_batched_key_bank(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        eye = np.stack([np.stack([np.eye(2), np.zeros((2, 2))])] * 3)
        freed = []
        for mod, gov, env in ((qt, RG, both[0]), (tq, G, both[1])):
            b = mod.createBatchedQureg(6, env, 3)
            mod.applyBatchedUnitary(b, [0], eye)
            mod.measureBatched(b, 0)  # advance the key bank
            if mod is tq:
                keys0 = b.key_state()
                amps0 = host(b)
            freed.append(gov.spill_register(b))
        assert freed[1] == freed[0] > 0
        np.testing.assert_array_equal(host(b), amps0)
        keys1 = b.key_state()
        assert keys1.keys() == keys0.keys()
        for k in keys0:
            np.testing.assert_array_equal(np.asarray(keys1[k]),
                                          np.asarray(keys0[k]))

    def test_destroyed_register_still_raises(self, penv):
        q = tq.createQureg(5, penv)
        tq.destroyQureg(q, penv)
        with pytest.raises(tq.QuESTError, match="destroyed"):
            _ = q.amps
        with pytest.raises(tq.QuESTError, match="destroyed"):
            q._amps_raw()

    def test_an_overwrite_drops_the_snapshot(self, penv, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        q = tq.createQureg(NBIG, penv)
        G.spill_register(q)
        tq.initPlusState(q)
        assert q._spill is None
        assert abs(tq.calcProbOfOutcome(q, 0, 0) - 0.5) < 1e-12

    def test_sparse_state_admitted_sparse_and_made_dense_lazily(
            self, both, monkeypatch):
        """Under a budget initSparseState holds the sparse description
        (admitted at its own cost, which a budget below the dense state
        accepts) and the first read makes the state the ungoverned route
        makes, in both packages."""
        idx = [0, 5, 77, (1 << NBIG) - 1]
        amps = np.array([0.5, 0.5j, -0.5, 0.5])
        want = tq.createQureg(NBIG, both[1])
        tq.initSparseState(want, idx, amps)
        want_amps = host(want)
        tq.destroyQureg(want, both[1])
        for mod, env in ((qt, both[0]), (tq, both[1])):
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
            r = mod.createQureg(NBIG, env)
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(STATE // 2))
            mod.initSparseState(r, idx, amps)
            assert r._amps is None and r._spill is not None
            assert r._spill.nbytes == 4 * 8 + 2 * 4 * 8
            got = host(r) if mod is tq else np.asarray(r.amps)
            np.testing.assert_array_equal(got, want_amps)

    def test_spilled_register_resumes_via_run_resumable(
            self, penv, tmp_path, monkeypatch):
        """A spilled register restores inside runResumable: the run is bit
        for bit the never-spilled one."""
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        gates = [PC.Gate((0, 1), U2_SOA), PC.Gate((4, 5), U2_SOA),
                 PC.Gate((2, 3), U2_SOA), PC.Gate((0, 5), U2_SOA)]
        tq.seedQuEST(penv, [3])
        ref = tq.createQureg(6, penv)
        tq.runResumable(ref, gates, str(tmp_path / "ref"), every=2)
        want = host(ref)
        tq.destroyQureg(ref, penv)
        tq.seedQuEST(penv, [3])
        q = tq.createQureg(6, penv)
        assert G.spill_register(q) > 0
        assert q._amps is None
        tq.runResumable(q, gates, str(tmp_path / "spilled"), every=2)
        np.testing.assert_array_equal(host(q), want)
        tq.destroyQureg(q, penv)


# ---------------------------------------------------------------------------
# Degradation ladder
# ---------------------------------------------------------------------------


def _rungs(tele):
    snap = tele.snapshot()["counters"].get("governor_degradations_total", {})
    return {k: v for k, v in snap.items() if v}


def _ladder_run(mod, gov, tele, degr, env, budget, monkeypatch,
                chunks=None):
    """_big_workload under ``budget``; (rungs fired, degradation reasons,
    state)."""
    monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(budget))
    if chunks is not None:
        monkeypatch.setenv("QT_EXCHANGE_CHUNKS", str(chunks))
    before = _rungs(tele)
    q = mod.createQureg(NBIG, env)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        _big_workload(mod, q)
    after = _rungs(tele)
    fired = {k: after[k] - before.get(k, 0) for k in after
             if after[k] != before.get(k, 0)}
    reasons = {k: v for k, v in degr.items()
               if k.startswith("memory_governor")}
    amps = host(q) if mod is tq else np.asarray(q.amps)
    mod.destroyQureg(q, env)
    monkeypatch.delenv("QT_HBM_BUDGET_BYTES")
    monkeypatch.delenv("QT_EXCHANGE_CHUNKS", raising=False)
    return fired, reasons, amps


class TestDegradationLadder:
    def test_chunk_bump_completes_bit_identically(self, both, monkeypatch):
        """A budget between the peak at 4 chunks (2.5 states) and the
        monolithic one (3 states), whichever package's pass arrays: both
        raise the chunks 1 -> 4 and complete, the port bit for bit its
        unconstrained run; the escalation is cleared after the drain."""
        rmem, ramps = _predict(qt, RG, both[0], monkeypatch)
        pmem, pamps = _predict(tq, G, both[1], monkeypatch)
        arrays = (rmem["pass_array_bytes"], pmem["pass_array_bytes"])
        lo, hi = int(2.5 * STATE) + max(arrays), 3 * STATE + min(arrays)
        assert lo < hi
        b = (lo + hi) // 2
        rf, rr, r_out = _ladder_run(qt, RG, RT, RR.DEGRADATIONS, both[0], b,
                                    monkeypatch)
        pf, pr, p_out = _ladder_run(tq, G, T, PR.DEGRADATIONS, both[1], b,
                                    monkeypatch)
        assert pf == rf == {"rung=chunks": 1}
        assert pr == rr
        assert "1 -> 4" in pr["memory_governor_chunks"]
        np.testing.assert_array_equal(p_out, pamps)
        np.testing.assert_allclose(p_out, r_out, atol=1e-10)
        assert PD._GOVERNOR_CHUNKS[0] is None
        assert RD._GOVERNOR_CHUNKS[0] is None
        assert any(k.startswith("memory_governor")
                   for k in tq.degradation_report())

    def test_split_rung_groups_the_program(self, both, monkeypatch):
        """QT_EXCHANGE_CHUNKS=1 pins the chunks; a budget of three states
        leaves the remap no room for pass arrays beside it: both split the
        program into the same number of dispatch groups and complete bit
        for bit."""
        _rmem, ramps = _predict(qt, RG, both[0], monkeypatch)
        _pmem, pamps = _predict(tq, G, both[1], monkeypatch)
        rf, rr, r_out = _ladder_run(qt, RG, RT, RR.DEGRADATIONS, both[0],
                                    3 * STATE, monkeypatch, chunks=1)
        pf, pr, p_out = _ladder_run(tq, G, T, PR.DEGRADATIONS, both[1],
                                    3 * STATE, monkeypatch, chunks=1)
        assert pf == rf == {"rung=split": 1}
        assert pr == rr
        assert pr["memory_governor_split"] == \
            "drain split into 2 dispatch groups"
        np.testing.assert_array_equal(p_out, pamps)
        np.testing.assert_allclose(p_out, r_out, atol=1e-10)

    def test_spill_rung_evicts_idle_register(self, both, monkeypatch):
        """Shrinking transients cannot make the drain fit: the ladder
        spills the least recently used idle register, which restores bit
        for bit."""
        out = []
        for mod, gov, tele, env in ((qt, RG, RT, both[0]),
                                    (tq, G, T, both[1])):
            idle = mod.createQureg(NBIG, env)
            mod.initPlusState(idle)
            want = host(idle) if mod is tq else np.asarray(idle.amps)
            active = mod.createQureg(6, env)
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES",
                               str(gov.register_bytes_per_device(idle)))
            before = _rungs(tele)
            spills0 = tele.counter_total("spills_total")
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                with mod.gateFusion(active):
                    mod.multiQubitUnitary(active, [0, 1], U2)
            assert tele.counter_total("spills_total") == spills0 + 1
            assert idle._amps is None
            out.append({k: v - before.get(k, 0)
                        for k, v in _rungs(tele).items()
                        if v != before.get(k, 0)})
            monkeypatch.delenv("QT_HBM_BUDGET_BYTES")
            got = host(idle) if mod is tq else np.asarray(idle.amps)
            np.testing.assert_array_equal(got, want)
            mod.destroyQureg(idle, env)
            mod.destroyQureg(active, env)
        assert out[1] == out[0] == {"rung=spill": 1}

    def test_strict_raises_before_dispatch(self, both, monkeypatch):
        """strict refuses the drain at once with the same available and
        budget bytes; the gates stay queued and the lifted constraint lets
        the same drain complete bit for bit."""
        rmem, _ramps = _predict(qt, RG, both[0], monkeypatch)
        pmem, pamps = _predict(tq, G, both[1], monkeypatch)
        b = min(rmem["predicted_total_bytes"],
                pmem["predicted_total_bytes"]) - 1
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(b))
        monkeypatch.setenv("QT_MEM_POLICY", "strict")
        rejects0 = T.counter_value("admission_rejects_total", func="drain")
        errs, regs = [], []
        for mod, env in ((qt, both[0]), (tq, both[1])):
            q = mod.createQureg(NBIG, env)
            errs.append(_refusal(lambda: _big_workload(mod, q)))
            regs.append(q)
        assert errs[1].available_bytes == errs[0].available_bytes == b
        assert errs[1].budget_bytes == errs[0].budget_bytes == b
        assert errs[1].predicted_bytes == pmem["predicted_total_bytes"]
        assert T.counter_value("admission_rejects_total",
                               func="drain") == rejects0 + 1
        q = regs[1]
        assert len(q._fusion.gates) == 2
        monkeypatch.delenv("QT_HBM_BUDGET_BYTES")
        monkeypatch.delenv("QT_MEM_POLICY")
        np.testing.assert_array_equal(host(q), pamps)

    def test_a_drain_nothing_can_fit_is_refused(self, both, monkeypatch):
        """Under degrade a budget below one state: every rung fails and
        both refuse with the same available and budget bytes."""
        errs = []
        for mod, env in ((qt, both[0]), (tq, both[1])):
            q = mod.createQureg(NBIG, env)
            monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(STATE + 1))
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                errs.append(_refusal(lambda: _big_workload(mod, q)))
            monkeypatch.delenv("QT_HBM_BUDGET_BYTES")
            mod.destroyQureg(q, env)
        assert (errs[1].available_bytes, errs[1].budget_bytes) == \
            (errs[0].available_bytes, errs[0].budget_bytes) == \
            (STATE + 1, STATE + 1)
        assert PD._GOVERNOR_CHUNKS[0] is None

    def test_env_chunk_override_wins_over_ladder(self, both, monkeypatch):
        """An explicit QT_EXCHANGE_CHUNKS is never fought: no chunk rung
        in either package."""
        rmem, _ = _predict(qt, RG, both[0], monkeypatch)
        pmem, pamps = _predict(tq, G, both[1], monkeypatch)
        b = min(rmem["predicted_total_bytes"],
                pmem["predicted_total_bytes"]) - 1
        rf, _rr, _ = _ladder_run(qt, RG, RT, RR.DEGRADATIONS, both[0], b,
                                 monkeypatch, chunks=1)
        pf, _pr, p_out = _ladder_run(tq, G, T, PR.DEGRADATIONS, both[1], b,
                                     monkeypatch, chunks=1)
        assert "rung=chunks" not in pf and "rung=chunks" not in rf
        assert pf == rf
        np.testing.assert_array_equal(p_out, pamps)


# ---------------------------------------------------------------------------
# Surfaces and the OOM net
# ---------------------------------------------------------------------------


class TestSurfaces:
    def test_environment_string_reports_governor(self, both, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        s = tq.getEnvironmentString(both[1])
        r = qt.getEnvironmentString(both[0])
        frag = f"MemGovernor=degrade(budget={1 << 30} resident=0)"
        assert frag in s and frag in r

    def test_perf_report_summary_line(self, penv, monkeypatch):
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        q = tq.createQureg(NBIG, penv)
        _big_workload(tq, q)
        line = G.summary_line()
        assert line is not None and "governor" in line
        assert line in T.perf_report()
        tq.destroyQureg(q, penv)

    def test_refresh_budget_reprices_after_a_mesh_change(self, both,
                                                         monkeypatch):
        """After a failover shrinks a register's mesh, refresh_budget
        prices it against its current env: twice the bytes per device on
        half the shards, as the reference does."""
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 30))
        for mod, gov, tele, env, env4 in (
                (qt, RG, RT, both[0], qt.createQuESTEnv(num_devices=4)),
                (tq, G, T, both[1], tq.createQuESTEnv(devices=["cpu"] * 4))):
            q = mod.createQureg(NBIG, env)
            assert gov.resident_bytes() == STATE
            before = tele.counter_total("governor_budget_rederivations_total")
            q.env = env4
            gov.refresh_budget()
            assert gov.resident_bytes() == 2 * STATE
            assert tele.counter_total(
                "governor_budget_rederivations_total") == before + 1
            q.env = env
            gov.refresh_budget()
            mod.destroyQureg(q, env)

    def test_invalid_policy_degrades_to_default(self, monkeypatch):
        monkeypatch.setenv("QT_MEM_POLICY", "aggressive")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            assert G.policy() == RG.policy() == "degrade"

    def test_oom_errors_by_type_and_text(self):
        assert G._is_oom(torch.cuda.OutOfMemoryError("boom"))
        assert G._is_oom(RuntimeError("CUDA out of memory. Tried to "
                                      "allocate 8.00 GiB"))
        assert G._is_oom(G._InjectedOOM("RESOURCE_EXHAUSTED: injected"))
        assert not G._is_oom(RuntimeError("CUDA error: illegal address"))

    def test_injected_oom_on_a_plain_drain_retries_once(self, both):
        """oom@0 outside runResumable: the drain's dispatch fails once,
        the net retries, both packages count one retry and the result is
        the unfaulted drain's."""
        u = np.linalg.qr(np.random.default_rng(5).normal(size=(4, 4)))[0]
        outs = []
        for mod, res, tele, env in ((qt, RR, RT, both[0]),
                                    (tq, PR, T, both[1])):
            qa = mod.createQureg(6, env)
            qb = mod.createQureg(6, env)
            plan = mod.FaultPlan("oom@0")
            before = tele.counter_total("oom_retries_total")
            res._ACTIVE_FAULTS[0] = plan
            try:
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    with mod.gateFusion(qa):
                        mod.multiQubitUnitary(qa, [0, 1], u)
            finally:
                res._ACTIVE_FAULTS[0] = None
            with mod.gateFusion(qb):
                mod.multiQubitUnitary(qb, [0, 1], u)
            assert plan.log == ["oom@0"]
            assert tele.counter_total("oom_retries_total") == before + 1
            get = host if mod is tq else (lambda q: np.asarray(q.amps))
            np.testing.assert_array_equal(get(qa), get(qb))
            outs.append(get(qa))
        np.testing.assert_allclose(outs[1], outs[0], atol=1e-10)

    def test_real_oom_before_any_change_spills_idle_and_retries(
            self, penv, monkeypatch):
        """An allocator failure with the register's state untouched: the
        net spills the idle registers, empties the caches and retries
        once; the result is the unfaulted drain's."""
        idle = tq.createQureg(NBIG, penv)
        q = tq.createQureg(NBIG, penv)
        want = tq.createQureg(NBIG, penv)
        for r in (q, want):
            _big_workload(tq, r)
        real = PF.execute_sharded_program
        calls = []

        def flaky(*args, **kwargs):
            calls.append(1)
            if len(calls) == 1:
                raise torch.cuda.OutOfMemoryError(
                    "CUDA out of memory. Tried to allocate 8.00 GiB")
            return real(*args, **kwargs)

        monkeypatch.setattr(PF, "execute_sharded_program", flaky)
        retries0 = T.counter_total("oom_retries_total")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with tq.gateFusion(q):
                tq.multiQubitUnitary(q, [3, 4], U2)
        monkeypatch.setattr(PF, "execute_sharded_program", real)
        with tq.gateFusion(want):
            tq.multiQubitUnitary(want, [3, 4], U2)
        assert len(calls) == 2
        assert T.counter_total("oom_retries_total") == retries0 + 1
        assert idle._amps is None and idle._spill is not None
        np.testing.assert_array_equal(host(q), host(want))

    def test_real_oom_after_an_in_place_part_propagates(self, monkeypatch):
        """An allocator failure after the attempt changed the state in
        place (as K5's sweep or K10's swap do on the card) is not retried:
        the error propagates, no retry is counted and the gates go back
        to the buffer."""
        env = tq.createQuESTEnv(device="cpu")
        q = tq.createQureg(6, env)
        real = PF.execute_program

        def in_place_then_oom(amps, program, probs, n):
            amps.mul_(1.0)
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 8.00 GiB")

        monkeypatch.setattr(PF, "execute_program", in_place_then_oom)
        retries0 = T.counter_total("oom_retries_total")
        with pytest.raises(torch.cuda.OutOfMemoryError):
            with tq.gateFusion(q):
                tq.multiQubitUnitary(q, [0, 1], U2)
        assert T.counter_total("oom_retries_total") == retries0
        assert len(q._fusion.gates) == 1
        monkeypatch.setattr(PF, "execute_program", real)
        tq.stopGateFusion(q)
        want = tq.createQureg(6, env)
        with tq.gateFusion(want):
            tq.multiQubitUnitary(want, [0, 1], U2)
        np.testing.assert_array_equal(host(q), host(want))
