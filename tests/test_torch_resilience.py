"""Resumable runs, fault injection, the watchdog and the elastic failover
(M16b) in the port against the JAX package.

The classes of tests/test_resilience.py, tests/test_elastic.py and
tests/test_batch.py::TestBatchedCheckpointResume, each held against the
reference's run_resumable for the same circuit and FaultPlan spec: the
same fired faults, cursors, permutations, errors and watchdog windows,
and resumed amplitudes within 1e-10 of the reference's (bit for bit
against the port's own uninterrupted run).  The circuit fingerprint is
the reference's.  Registers of 6 qubits (64 amplitudes) on one shard
and on in-process CPU meshes of 4 and 8 shards, float64; reference
registers use ``qt.createQuESTEnv(num_devices=R)``.
"""

import json
import logging
import os
import shutil
import warnings

import numpy as np
import pytest

import quest_tpu as qt
from quest_tpu import circuit as RC
from quest_tpu import resilience as RR
from quest_tpu import rng as RRNG
from quest_tpu.ops import measurement as RM
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import fusion as PF
from quest_tpu_torch import interop, precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import rng as PRNG
from quest_tpu_torch import telemetry as PT
from quest_tpu_torch.ops import measurement as PM
from quest_tpu_torch.parallel import dist as PD

N = 6
EVERY = 8
TOL = 1e-10
H = np.stack([(1 / np.sqrt(2)) * np.array([[1.0, 1], [1, -1]]),
              np.zeros((2, 2))])
CX = np.stack([np.array([[1.0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1],
                         [0, 0, 1, 0]]), np.zeros((4, 4))])


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """Fast retries, float64, telemetry on, and both packages' measurement
    streams and degradation registries restored afterwards."""
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0.001")
    old = precision.get_precision()
    tq.set_precision(2)
    PT.configure("on")
    PT.reset()
    states = (RRNG.GLOBAL_RNG.get_state(), RM.KEYS.get_state(),
              PRNG.GLOBAL_RNG.get_state(), PM.KEYS.get_state())
    degr = dict(PR.DEGRADATIONS)
    yield
    RRNG.GLOBAL_RNG.set_state(states[0])
    RM.KEYS.set_state(states[1])
    PRNG.GLOBAL_RNG.set_state(states[2])
    PM.KEYS.set_state(states[3])
    PR.DEGRADATIONS.clear()
    PR.DEGRADATIONS.update(degr)
    tq.set_precision(old)


def _circuit(mod, n=N, depth=4):
    """Entangling brickwork reaching every qubit, the sharded ones too,
    so window drains leave a live permutation (the reference's)."""
    gates = []
    for _ in range(depth):
        for t in range(n):
            gates.append(mod.Gate((t,), H))
        for t in range(n - 1):
            gates.append(mod.Gate((t, t + 1), CX))
    return gates


def penv(R):
    return tq.createQuESTEnv(devices=["cpu"] * R) if R > 1 \
        else tq.createQuESTEnv(device="cpu")


def pfresh(env, seed=7, n=N):
    tq.seedQuEST(env, [seed])
    return tq.createQureg(n, env)


def rfresh(env, seed=7, n=N):
    qt.seedQuEST(env, [seed])
    return qt.createQureg(n, env)


def host(q):
    return interop.register_state(q, canonical=True)[0]


def prun(q, ckpt, spec="", **kw):
    """The port's run_resumable under ``spec``; (plan, exception)."""
    plan = tq.FaultPlan(spec) if spec else None
    try:
        tq.runResumable(q, _circuit(PC), str(ckpt), every=kw.pop("every",
                                                                 EVERY),
                        faults=plan, **kw)
    except (tq.SimulatedPreemption, tq.QuESTError, PD.ShardLossError) as e:
        return plan, e
    return plan, None


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's run_resumable, memoised per (R, spec, watchdog):
    (final amplitudes, fired faults, exception or None, latest meta)."""
    memo = {}

    def get(R, spec="", watchdog="raise", resume=False):
        key = (R, spec, watchdog, resume)
        if key not in memo:
            env = qt.createQuESTEnv(num_devices=R)
            d = str(tmp_path_factory.mktemp("ref"))
            q = rfresh(env)
            plan = qt.FaultPlan(spec) if spec else None
            err = None
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                try:
                    qt.run_resumable(q, _circuit(RC), d, every=EVERY,
                                     watchdog=watchdog, faults=plan)
                except (RR.SimulatedPreemption, qt.QuESTError) as e:
                    err = e
                loaded = RR.load_latest(d, env)
                meta = loaded[1] if loaded is not None else None
                if resume:
                    q = rfresh(env, seed=999)
                    qt.run_resumable(q, _circuit(RC), d, every=EVERY)
            memo[key] = (np.asarray(q.amps), None if plan is None
                         else list(plan.log), err, meta,
                         RRNG.GLOBAL_RNG.uniform())
        return memo[key]
    return get


@pytest.fixture(scope="module")
def own():
    """The port's uninterrupted run per R: (amplitudes, next uniform)."""
    memo = {}

    def get(R, d):
        if R not in memo:
            tq.set_precision(2)
            q = pfresh(penv(R))
            tq.runResumable(q, _circuit(PC), str(d / f"own{R}"), every=EVERY)
            memo[R] = (host(q), PRNG.GLOBAL_RNG.uniform())
        return memo[R]
    return get


# ---------------------------------------------------------------------------
# TestResumeBitExact
# ---------------------------------------------------------------------------


class TestResumeBitExact:
    @pytest.mark.parametrize("R", [1, 8])
    def test_uninterrupted_equals_plain_drains_and_the_reference(
            self, ref, own, tmp_path, R):
        q = pfresh(penv(R))
        gates = _circuit(PC)
        for cur in range(0, len(gates), EVERY):
            PF.start_gate_fusion(q)
            q._fusion.gates.extend(gates[cur:cur + EVERY])
            PF.stop_gate_fusion(q)
        got = own(R, tmp_path)[0]
        assert np.array_equal(host(q), got)
        assert np.abs(got - ref(R)[0]).max() < TOL

    @pytest.mark.parametrize("R", [1, 8])
    def test_kill_then_resume_bit_identical(self, ref, own, tmp_path, R):
        env = penv(R)
        want, u = own(R, tmp_path)
        plan, err = prun(pfresh(env), tmp_path / "ck", "kill@3")
        r_amps, r_log, r_err, r_meta, _ = ref(R, "kill@3")
        assert isinstance(err, tq.SimulatedPreemption)
        assert isinstance(r_err, RR.SimulatedPreemption)
        assert plan.log == r_log == ["kill@3"]
        _q, meta = PR.load_latest(str(tmp_path / "ck"), env)
        assert meta["cursor"] == r_meta["cursor"] == 24
        assert meta["perm"] == r_meta["perm"]
        if R == 8:
            assert meta["perm"] is not None
            assert meta["perm"] != list(range(N))
        q2 = pfresh(env, seed=999)
        tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        assert np.array_equal(host(q2), want)
        assert PRNG.GLOBAL_RNG.uniform() == u
        assert np.abs(host(q2) - ref(R, "kill@3", resume=True)[0]).max() \
            < TOL

    def test_resume_bit_identical_with_chunked_exchange(
            self, own, tmp_path, monkeypatch):
        monkeypatch.setenv("QT_EXCHANGE_CHUNKS", "4")
        env = penv(8)
        prun(pfresh(env), tmp_path / "ck", "kill@3")
        q2 = pfresh(env)
        tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        monkeypatch.delenv("QT_EXCHANGE_CHUNKS")
        assert np.array_equal(host(q2), own(8, tmp_path)[0])

    def test_checkpoints_at_window_boundaries_only(self, tmp_path):
        q = pfresh(penv(1))
        tq.runResumable(q, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        assert q._drain_count == len(PC.plan_checkpoint_boundaries(
            len(_circuit(PC)), EVERY))
        assert PT.counter_total("checkpoints_total") == q._drain_count

    def test_resume_refuses_different_circuit(self, tmp_path):
        env = penv(1)
        prun(pfresh(env), tmp_path / "ck", "kill@2")
        with pytest.raises(tq.QuESTError, match="different circuit"):
            tq.runResumable(pfresh(env), _circuit(PC, depth=2),
                            str(tmp_path / "ck"), every=EVERY)
        with pytest.raises(tq.QuESTError, match="different circuit"):
            tq.runResumable(pfresh(env), _circuit(PC),
                            str(tmp_path / "ck"), every=4)


@pytest.mark.parametrize("n,every", [(6, 8), (6, 5), (4, 3), (8, 64)])
def test_fingerprint_is_the_reference(n, every):
    gates = _circuit(PC, n=n)
    assert PR.circuit_fingerprint(gates, n, every) == \
        RR.circuit_fingerprint(_circuit(RC, n=n), n, every)


# ---------------------------------------------------------------------------
# Kill mid-save, corruption, transient IO
# ---------------------------------------------------------------------------


class TestKillMidSave:
    def test_mid_save_kill_leaves_loadable_last_good(self, ref, own,
                                                     tmp_path):
        env = penv(1)
        plan, err = prun(pfresh(env), tmp_path / "ck", "killsave@2")
        r = ref(1, "killsave@2")
        assert isinstance(err, tq.SimulatedPreemption)
        assert plan.log == r[1] == ["killsave@2"]
        _q, meta = PR.load_latest(str(tmp_path / "ck"), env)
        assert meta["cursor"] == r[3]["cursor"] == 16
        q2 = pfresh(env)
        tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        assert np.array_equal(host(q2), own(1, tmp_path)[0])

    def test_a_failed_payload_write_never_commits(self, tmp_path,
                                                  monkeypatch):
        """The generation's payload thread fails: nothing is committed
        past the previous generation, which stays loadable."""
        env = penv(1)
        q = pfresh(env)
        tq.runResumable(q, _circuit(PC)[:16], str(tmp_path / "ck"),
                        every=EVERY)

        def fail(gen, arr):
            raise OSError("disk full")

        monkeypatch.setattr(PR, "_write_npy", fail)
        monkeypatch.setenv("QT_RETRY_ATTEMPTS", "2")
        with pytest.raises(tq.QuESTError, match="saveQureg\\(amps\\)"):
            PR.save_generation(q, str(tmp_path / "ck"), 24)
        assert PR.latest_committed_cursor(str(tmp_path / "ck")) == 16
        _q, meta = PR.load_latest(str(tmp_path / "ck"), env)
        assert meta["cursor"] == 16


class TestCorruptCheckpoint:
    def test_corrupt_newest_falls_back_to_predecessor(self, ref, own,
                                                      tmp_path):
        env = penv(1)
        plan, _err = prun(pfresh(env), tmp_path / "ck", "corrupt@2,kill@3")
        assert plan.log == ref(1, "corrupt@2,kill@3")[1]
        q2 = pfresh(env)
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"),
                            every=EVERY)
        assert any("unreadable" in str(x.message) for x in w)
        assert np.array_equal(host(q2), own(1, tmp_path)[0])

    def test_all_generations_corrupt_raises(self, tmp_path):
        env = penv(1)
        prun(pfresh(env), tmp_path / "ck", "kill@3")
        for gen in (tmp_path / "ck").glob("gen-*"):
            PR._corrupt_generation(str(gen))
        with pytest.raises(tq.QuESTError, match="no loadable checkpoint"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                tq.runResumable(pfresh(env), _circuit(PC),
                                str(tmp_path / "ck"), every=EVERY)


class TestTransientIO:
    def test_retry_absorbs_transient_errors(self, ref, own, tmp_path):
        q = pfresh(penv(1))
        plan, err = prun(q, tmp_path / "ck", "io@3")
        assert err is None
        assert plan.log.count("io") == ref(1, "io@3")[1].count("io") == 3
        assert plan.io_budget == 0
        assert np.array_equal(host(q), own(1, tmp_path)[0])

    def test_retry_io_bounded(self):
        calls = []

        def always_fails():
            calls.append(1)
            raise OSError("disk on fire")

        with pytest.raises(tq.QuESTError, match="failed after 3 attempts"):
            PR.retry_io(always_fails, attempts=3, base_delay=0.0,
                        what="test-op")
        assert len(calls) == 3

    def test_retry_io_returns_value(self):
        assert PR.retry_io(lambda: 42, attempts=2, base_delay=0.0) == 42

    def test_backoff_is_bounded_and_seeded(self):
        PR.seed_backoff_jitter([7])
        RR.seed_backoff_jitter([7])
        prev_p = prev_r = None
        for _ in range(20):
            prev_p = PR.backoff_delay(0.01, prev_p)
            prev_r = RR.backoff_delay(0.01, prev_r)
            assert prev_p == prev_r
            assert 0.01 <= prev_p <= 0.64


# ---------------------------------------------------------------------------
# The watchdog
# ---------------------------------------------------------------------------


class TestWatchdog:
    @pytest.mark.parametrize("R", [1, 8])
    def test_health_check_clean(self, R):
        q = pfresh(penv(R))
        tq.hadamard(q, 0)
        norm, finite = tq.checkQuregHealth(q)
        assert finite and abs(norm - 1.0) < 1e-12

    @pytest.mark.parametrize("R", [1, 8])
    def test_nan_detected_within_one_window(self, ref, tmp_path, R):
        _plan, err = prun(pfresh(penv(R)), tmp_path / "ck", "nan@1")
        r_err = ref(R, "nan@1")[2]
        assert isinstance(err, tq.NumericalHealthError)
        assert err.window == r_err.window == (8, 16)
        assert not err.finite and not r_err.finite
        assert "window [8, 16)" in str(err)

    def test_rollback_restores_last_good(self, ref, own, tmp_path):
        env = penv(1)
        q = pfresh(env)
        _plan, err = prun(q, tmp_path / "ck", "nan@2", watchdog="rollback")
        assert err.rolled_back_to == ref(1, "nan@2", "rollback")[2]\
            .rolled_back_to == 16
        qp = pfresh(env)
        tq.runResumable(qp, _circuit(PC)[:16], str(tmp_path / "partial"),
                        every=EVERY)
        assert np.array_equal(host(q), host(qp))
        q2 = pfresh(env)
        tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        assert np.array_equal(host(q2), own(1, tmp_path)[0])

    def test_renormalize_policy(self, ref, tmp_path):
        q = pfresh(penv(1))
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            prun(q, tmp_path / "ck", "scale@1", watchdog="renormalize")
        assert any("renormalized" in str(x.message) for x in w)
        norm, finite = tq.checkQuregHealth(q)
        assert finite and abs(norm - 1.0) < 1e-10
        assert np.abs(host(q) - ref(1, "scale@1", "renormalize")[0]).max() \
            < TOL
        assert PT.counter_value("watchdog_verdicts_total",
                                policy="renormalize",
                                verdict="renormalized") == 1

    def test_renormalize_does_not_mask_nonfinite(self, tmp_path):
        _plan, err = prun(pfresh(penv(1)), tmp_path / "ck", "inf@1",
                          watchdog="renormalize")
        assert isinstance(err, tq.NumericalHealthError)

    def test_unknown_policy_rejected(self, tmp_path):
        with pytest.raises(tq.QuESTError, match="watchdog policy"):
            tq.runResumable(pfresh(penv(1)), _circuit(PC),
                            str(tmp_path / "ck"), watchdog="panic")

    def test_density_checks_finiteness_only(self, tmp_path):
        env = penv(1)
        rho = tq.createDensityQureg(3, env)
        tq.mixDepolarising(rho, 0, 0.5)
        norm, finite = tq.checkQuregHealth(rho)
        assert finite and norm < 1.0
        gates = [PC.Gate((0,), H), PC.Gate((3,), H)]
        tq.runResumable(rho, gates, str(tmp_path / "ck"), every=1)


# ---------------------------------------------------------------------------
# The measurement streams across a resume
# ---------------------------------------------------------------------------


class TestRNGStateRoundTrip:
    def test_host_mt_stream_resumes(self, monkeypatch):
        monkeypatch.setenv("QT_HOST_MEASURE", "1")
        env = penv(1)
        tq.seedQuEST(env, [11])
        q = tq.createQureg(4, env)
        tq.initPlusState(q)
        for _ in range(3):
            tq.measure(q, 0)
        snap = PRNG.GLOBAL_RNG.get_state()
        amps = host(q).copy()
        qa = tq.createQureg(4, env)
        interop.load_register(qa, amps)
        uninterrupted = [tq.measure(qa, t) for t in (1, 2, 3)]
        PRNG.GLOBAL_RNG.set_state(json.loads(json.dumps(snap)))
        qb = tq.createQureg(4, env)
        interop.load_register(qb, amps)
        assert [tq.measure(qb, t) for t in (1, 2, 3)] == uninterrupted

    def test_device_key_stream_resumes(self):
        env = penv(1)
        tq.seedQuEST(env, [13])
        q = tq.createQureg(4, env)
        tq.initPlusState(q)
        tq.measure(q, 0)
        snap = json.loads(json.dumps(PM.KEYS.get_state()))
        amps = host(q).copy()
        uninterrupted = [tq.measure(q, t) for t in (1, 2, 3)]
        PM.KEYS.set_state(snap)
        qb = tq.createQureg(4, env)
        interop.load_register(qb, amps)
        assert [tq.measure(qb, t) for t in (1, 2, 3)] == uninterrupted

    @pytest.mark.parametrize("R", [1, 8])
    def test_resumed_run_continues_the_reference_stream(self, tmp_path, R):
        env = penv(R)
        q2 = pfresh(env)
        prun(q2, tmp_path / "ck", "kill@3")
        q3 = pfresh(env, seed=999)
        tq.runResumable(q3, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        got = tq.measureSequence(q3, list(range(N)))[0]
        renv = qt.createQuESTEnv(num_devices=R)
        rq = rfresh(renv)
        qt.run_resumable(rq, _circuit(RC), str(tmp_path / "ref"),
                         every=EVERY)
        assert got == qt.measureSequence(rq, list(range(N)))[0]


# ---------------------------------------------------------------------------
# FaultPlan, the guard, the elastic contracts, the boundaries
# ---------------------------------------------------------------------------


class TestFaultPlanParsing:
    @pytest.mark.parametrize("spec", [
        "kill@2, nan@5, io@4", "killsave@1", "stall@2, shard_loss@3",
        "host_loss@1,corrupt@0,scale@3,inf@2", "bank_fault@4,heal@5",
        "poison_job@7,poison_job@9,io@1,io@2"])
    def test_parse_equals_the_reference(self, spec):
        p, r = tq.FaultPlan(spec), qt.FaultPlan(spec)
        assert p.events == r.events
        assert p.io_budget == r.io_budget
        assert p.poisoned_jobs == r.poisoned_jobs

    def test_env(self, monkeypatch):
        monkeypatch.setenv("QT_FAULT_PLAN", "killsave@1")
        got = tq.FaultPlan.from_env()
        assert got is not None and ("killsave", 1) in got.events
        monkeypatch.delenv("QT_FAULT_PLAN")
        assert tq.FaultPlan.from_env() is None

    def test_unknown_kind_rejected(self):
        with pytest.raises(tq.QuESTError, match="unknown fault kind"):
            tq.FaultPlan("meteor@3")  # qlint: allow(fault-plan-spec): deliberately unknown kind — the test pins the rejection path

    def test_arm_and_take_exchange_faults(self):
        logs = []
        for mod in (tq, qt):
            plan = mod.FaultPlan("stall@1, shard_loss@1")
            seq = [plan.take_exchange_fault("drain")]
            plan.arm_exchange_window(0)
            seq.append(plan.take_exchange_fault("drain"))
            plan.arm_exchange_window(1)
            seq += [plan.take_exchange_fault("drain") for _ in range(3)]
            logs.append((seq, plan.log))
        assert logs[0] == logs[1]
        assert logs[0][0] == [None, None, "shard_loss", "stall", None]

    def test_io_faults_exact_under_concurrent_writers(self):
        """The payload thread and the metadata write both take injected
        IO faults: under contention exactly the budget fires."""
        import sys
        import threading

        plan = tq.FaultPlan("io@500")
        barrier = threading.Barrier(8)
        fired = []

        def work():
            barrier.wait()
            fired.append(sum(plan.take_io_fault() for _ in range(200)))

        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=work) for _ in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30)
        finally:
            sys.setswitchinterval(old)
        assert not any(t.is_alive() for t in threads)
        assert sum(fired) == 500 and plan.io_budget == 0
        assert plan.log.count("io") == 500

    def test_oom_parses_and_arming_it_names_m16c(self, ref, own, tmp_path):
        """oom@W fires through the memory governor's OOM net: it parses,
        arms and is taken as the reference's, and oom@1 under
        runResumable fails window 1's dispatch once, the net retries and
        the run ends bit for bit the unfaulted one (the name predates the
        net, which M16c brought)."""
        seqs = []
        for mod in (tq, qt):
            plan = mod.FaultPlan("oom@2")
            seq = [plan.take_oom_fault()]
            plan.arm_exchange_window(1)
            seq.append(plan.take_oom_fault())
            plan.arm_exchange_window(2)
            seq += [plan.take_oom_fault() for _ in range(2)]
            seqs.append((plan.events, seq, plan.log))
        assert seqs[0] == seqs[1]
        assert seqs[0][1] == [False, False, True, False]
        before = PT.counter_total("oom_retries_total")
        q = pfresh(penv(1))
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            plan, err = prun(q, tmp_path / "ck", "oom@1")
        assert err is None
        assert plan.log == ref(1, "oom@1")[1] == ["oom@1"]
        assert PT.counter_total("oom_retries_total") == before + 1
        assert np.array_equal(host(q), own(1, tmp_path)[0])
        assert np.abs(host(q) - ref(1, "oom@1")[0]).max() < TOL


@pytest.fixture
def _no_fault_hook():
    old = PD.EXCHANGE_FAULT_HOOK[0]
    PD.EXCHANGE_FAULT_HOOK[0] = None
    yield
    PD.EXCHANGE_FAULT_HOOK[0] = old


class TestGuardedDispatch:
    def test_passthrough_and_latency_histogram(self, _no_fault_hook):
        out = PD.guarded_dispatch(lambda a, k=None: (a, k), 5, k=7,
                                  op="unit_test", shards=8, consumes=False)
        assert out == (5, 7)
        h = PT.snapshot()["histograms"]["exchange_latency_seconds"]
        assert h["op=unit_test,shards=8"]["count"] == 1

    def test_transient_failure_retried(self, _no_fault_hook):
        calls = []

        def flaky(x):
            calls.append(x)
            if len(calls) < 3:
                raise RuntimeError("transient")
            return x * 2

        assert PD.guarded_dispatch(flaky, 21, op="unit_test",
                                   consumes=False) == 42
        assert len(calls) == 3

    def test_exhaustion_raises_shard_loss(self, _no_fault_hook, monkeypatch):
        monkeypatch.setenv("QT_EXCHANGE_RETRIES", "2")

        def always_fails(_x):
            raise RuntimeError("dead link")

        with pytest.raises(PD.ShardLossError, match="after 2 attempts"):
            PD.guarded_dispatch(always_fails, 1, op="unit_test",
                                consumes=False)

    def test_injected_shard_loss_raises_immediately(self, _no_fault_hook):
        PD.EXCHANGE_FAULT_HOOK[0] = lambda op: "shard_loss"
        with pytest.raises(PD.ShardLossError, match="injected shard loss"):
            PD.guarded_dispatch(lambda x: x, 1, op="unit_test")

    def test_injected_stall_absorbed_and_counted(self, _no_fault_hook):
        faults = iter(["stall"])
        PD.EXCHANGE_FAULT_HOOK[0] = lambda op: next(faults, None)
        assert PD.guarded_dispatch(lambda x: x + 1, 1, op="unit_test") == 2
        assert PT.counter_value("exchange_timeouts_total",
                                op="unit_test") == 1

    def test_deadline_overrun_counted_but_result_kept(self, _no_fault_hook,
                                                      monkeypatch):
        monkeypatch.setenv("QT_EXCHANGE_DEADLINE_S", "1e-9")
        assert PD.guarded_dispatch(lambda x: x, 9, op="unit_test") == 9
        assert PT.counter_value("exchange_timeouts_total",
                                op="unit_test") == 1


class TestElasticContracts:
    def test_validated_perm(self):
        for mod in (PR, RR):
            assert mod._validated_perm(None, 4) is None
            assert mod._validated_perm([1, 0, 2, 3], 4) == (1, 0, 2, 3)
            with pytest.raises(ValueError):
                mod._validated_perm([0, 0, 1, 2], 4)
            with pytest.raises(ValueError):
                mod._validated_perm([0, 1], 4)

    def test_shrink_env_validates(self):
        from quest_tpu_torch import env as ENV

        env = penv(8)
        tq.seedQuEST(env, [3])
        with pytest.raises(ValueError):
            ENV.shrink_env(env, 3)
        with pytest.raises(ValueError):
            ENV.shrink_env(env, 16)
        e2 = ENV.shrink_env(env, 2)
        assert e2.num_devices == 2 and e2.seeds == env.seeds
        e1 = ENV.shrink_env(env, 1)
        assert e1.num_devices == 1 and e1.mesh is None
        e4 = ENV.shrink_env(env, 4, exclude_indices=[0, 1, 2, 3])
        assert e4.num_devices == 4


class TestBoundaries:
    @pytest.mark.parametrize("args", [(44, 8), (16, 8), (16, 8, 8),
                                      (16, 8, 16), (3, 8), (770, 128),
                                      (770, 128, 384)])
    def test_plan_checkpoint_boundaries_equal_the_reference(self, args):
        assert PC.plan_checkpoint_boundaries(*args) == \
            RC.plan_checkpoint_boundaries(*args)
        with pytest.raises(ValueError):
            PC.plan_checkpoint_boundaries(8, 0)

    def test_completed_run_resumes_to_noop(self, own, tmp_path):
        env = penv(1)
        q = pfresh(env)
        tq.runResumable(q, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        q2 = pfresh(env)
        tq.runResumable(q2, _circuit(PC), str(tmp_path / "ck"), every=EVERY)
        assert np.array_equal(host(q2), own(1, tmp_path)[0])
        assert q2._drain_count == 0


class TestRunLog:
    def test_checkpoint_restore_and_watchdog_events(self, tmp_path, caplog):
        env = penv(1)
        with caplog.at_level(logging.INFO,
                             logger="quest_tpu_torch.resilience"):
            prun(pfresh(env), tmp_path / "ck", "kill@2")
            tq.runResumable(pfresh(env), _circuit(PC), str(tmp_path / "ck"),
                            every=EVERY)
        events = [json.loads(r.message)["event"] for r in caplog.records
                  if r.name == "quest_tpu_torch.resilience"]
        assert events.count("restore") == 1
        assert events.count("checkpoint") == 6
        assert events.count("watchdog") == 6
        assert PT.counter_total("checkpoint_restores_total") == 1
        assert PT.snapshot()["histograms"]["checkpoint_commit_seconds"][""][
            "count"] == 6


# ---------------------------------------------------------------------------
# tests/test_elastic.py: resume onto other meshes, the failover
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def killed8(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("killed8"))
    old = precision.get_precision()
    tq.set_precision(2)
    plan = tq.FaultPlan("kill@3")
    with pytest.raises(tq.SimulatedPreemption):
        tq.runResumable(pfresh(penv(8)), _circuit(PC), d, every=EVERY,
                        faults=plan)
    tq.set_precision(old)
    return d


def _copy(src, tmp_path):
    dst = str(tmp_path / "ckpt")
    shutil.copytree(src, dst)
    return dst


def _resume(env, d, seed=999):
    q = pfresh(env, seed=seed)
    tq.runResumable(q, _circuit(PC), d, every=EVERY)
    return q


class TestElasticResume:
    def test_killed_checkpoint_has_live_perm_and_mesh_meta(self, ref,
                                                           killed8):
        q, meta = PR.load_latest(killed8, penv(8))
        assert meta["cursor"] == 24 and meta["mesh_shards"] == 8
        assert meta["perm"] == ref(8, "kill@3")[3]["perm"]
        assert meta["perm"] != list(range(N))
        assert q._perm == tuple(meta["perm"])

    @pytest.mark.parametrize("R", [4, 1])
    def test_resume_8_to_r_bit_identical(self, ref, own, killed8, tmp_path,
                                         R):
        want, u = own(4, tmp_path)
        q = _resume(penv(R), _copy(killed8, tmp_path))
        assert q.env.num_devices == R
        if R == 4:
            assert np.array_equal(host(q), want)
        else:
            # one device holds no permutation: the restore puts the state
            # in canonical order and the later windows plan on all six
            # qubits, products in another order than on 4 shards
            assert q._perm is None
            assert np.abs(host(q) - want).max() < 1e-15
        assert PRNG.GLOBAL_RNG.uniform() == u
        assert PT.counter_total("elastic_restores_total") >= 1
        assert np.abs(host(q) - ref(4)[0]).max() < TOL

    def test_a_permuted_restore_on_one_device_is_canonical(self):
        """A permuted state restored onto one device is put in canonical
        order, and later gates act on their logical qubits: physical
        index 1 under the permutation (1, 0, 2) is logical qubit 1 set
        (index 2); X on qubit 0 then gives index 3."""
        q = tq.createQureg(3, penv(1))
        phys = np.zeros((2, 8))
        phys[0, 1] = 1.0
        interop.load_register(q, phys)
        q.bind_checkpoint_state(q._amps_raw(), (1, 0, 2), q.dtype)
        assert q._perm is None
        assert np.nonzero(host(q)[0])[0].tolist() == [2]
        tq.pauliX(q, 0)
        assert np.nonzero(host(q)[0])[0].tolist() == [3]

    def test_same_mesh_resume_unchanged(self, own, killed8, tmp_path):
        q = _resume(penv(8), _copy(killed8, tmp_path))
        assert np.array_equal(host(q), own(4, tmp_path)[0])

    def test_strict_mesh_refuses_shard_count_change(self, killed8):
        with pytest.raises(tq.QuESTError, match="mesh mismatch"):
            PR.load_latest(killed8, penv(4), strict_mesh=True)
        _q, meta = PR.load_latest(killed8, penv(8), strict_mesh=True)
        assert meta["cursor"] == 24


class TestElasticFallbacks:
    def test_corrupt_latest_pointer(self, own, killed8, tmp_path):
        d = _copy(killed8, tmp_path)
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("gen-NOT-A-CURSOR\n")
        assert np.array_equal(host(_resume(penv(4), d)),
                              own(4, tmp_path)[0])

    def test_corrupt_newest_generation_falls_back(self, own, killed8,
                                                  tmp_path):
        d = _copy(killed8, tmp_path)
        PR._corrupt_generation(os.path.join(d, PR._gen_name(24)))
        with pytest.warns(UserWarning, match="unreadable"):
            q = _resume(penv(4), d)
        assert np.array_equal(host(q), own(4, tmp_path)[0])

    def test_missing_newest_generation_falls_back(self, own, killed8,
                                                  tmp_path):
        d = _copy(killed8, tmp_path)
        shutil.rmtree(os.path.join(d, PR._gen_name(24)))
        assert np.array_equal(host(_resume(penv(4), d)),
                              own(4, tmp_path)[0])

    def test_garbled_perm_treated_as_corrupt(self, own, killed8, tmp_path):
        d = _copy(killed8, tmp_path)
        meta_path = os.path.join(d, PR._gen_name(24), "qureg_meta.json")
        with open(meta_path) as f:
            meta = json.load(f)
        meta["perm"] = [0] * N
        with open(meta_path, "w") as f:
            json.dump(meta, f)
        with pytest.warns(UserWarning, match="unreadable"):
            q = _resume(penv(4), d)
        assert np.array_equal(host(q), own(4, tmp_path)[0])


class TestFailover:
    def test_shard_loss_triggers_rollback_shrink_resume(self, own,
                                                        tmp_path):
        env = penv(8)
        q = pfresh(env)
        with pytest.warns(UserWarning, match="mesh_failover_8to4"):
            plan, err = prun(q, tmp_path / "ck", "shard_loss@2")
        assert err is None and plan.log == ["shard_loss@2"]
        assert q.env.num_devices == 4
        assert np.array_equal(host(q), own(4, tmp_path)[0])
        assert PT.counter_total("failovers_total") == 1
        assert "mesh_failover_8to4" in tq.degradation_report()
        gauges = PT.snapshot()["gauges"]
        for phase in ("detect", "rollback", "reshard", "resume"):
            vals = list(gauges[f"failover_{phase}_seconds"].values())
            assert len(vals) == 1 and vals[0] >= 0.0
        assert "Failovers=1" in tq.getEnvironmentString(env)

    def test_host_loss_fails_over_onto_surviving_host(self, own, tmp_path,
                                                      monkeypatch):
        monkeypatch.setenv("QT_TOPOLOGY", "2x4")
        henv = penv(8)
        assert (henv.topology.hosts, henv.topology.chips) == (2, 4)
        q = pfresh(henv)
        with pytest.warns(UserWarning, match="mesh_failover_8to4"):
            plan, err = prun(q, tmp_path / "ck", "host_loss@2")
        assert err is None and plan.log == ["host_loss@2"]
        assert q.env.num_devices == 4
        assert (q.env.topology.hosts, q.env.topology.chips) == (1, 4)
        monkeypatch.delenv("QT_TOPOLOGY")
        assert np.abs(host(q) - own(4, tmp_path)[0]).max() < TOL
        assert "(host 1 excluded)" in \
            tq.degradation_report()["mesh_failover_8to4"]

    @pytest.mark.parametrize("kind", ["shard_loss", "host_loss"])
    def test_elastic_false_propagates(self, tmp_path, kind):
        _plan, err = prun(pfresh(penv(8)), tmp_path / "ck", f"{kind}@2",
                          elastic=False)
        assert isinstance(err, PD.ShardLossError)

    def test_stall_absorbed_by_retry_budget(self, own, tmp_path):
        q = pfresh(penv(8))
        plan, err = prun(q, tmp_path / "ck", "stall@1")
        assert err is None and plan.log == ["stall@1"]
        assert q.env.num_devices == 8
        assert PT.counter_total("exchange_timeouts_total") >= 1
        assert np.array_equal(host(q), own(4, tmp_path)[0])

    def test_shard_loss_before_first_checkpoint_raises(self, tmp_path):
        _plan, err = prun(pfresh(penv(8)), tmp_path / "ck", "shard_loss@0")
        assert isinstance(err, tq.QuESTError)
        assert "cannot fail over" in str(err)

    def test_exchange_latency_histogram_recorded(self, tmp_path):
        tq.runResumable(pfresh(penv(8)), _circuit(PC), str(tmp_path / "ck"),
                        every=EVERY)
        hists = PT.snapshot()["histograms"]["exchange_latency_seconds"]
        assert any("op=drain" in k for k in hists)


class TestWindowExecutor:
    def test_steps_and_health(self, own, tmp_path):
        env = penv(8)
        q = pfresh(env)
        ex = tq.WindowExecutor(q, _circuit(PC), every=EVERY)
        assert ex.num_windows == 6 and ex.window == 0
        while not ex.done:
            ex.step()
            ex.check_health()
        assert ex.cursor == len(_circuit(PC))
        assert np.array_equal(host(q), own(8, tmp_path)[0])
        ex2 = tq.WindowExecutor(pfresh(env), _circuit(PC), every=EVERY)
        ex2.step()
        ex2.checkpoint(str(tmp_path / "ck"))
        assert PR.latest_committed_cursor(str(tmp_path / "ck")) == 8


# ---------------------------------------------------------------------------
# tests/test_batch.py::TestBatchedCheckpointResume
# ---------------------------------------------------------------------------

NQ = 4
NB = 4


def _bank_gates(mod, rng, count=12):
    out = []
    for k in range(count):
        a = rng.normal(size=(2, 2)) + 1j * rng.normal(size=(2, 2))
        u = np.linalg.qr(a)[0]
        out.append(mod.Gate((k % NQ,), np.stack([u.real, u.imag])))
    return out


class TestBatchedCheckpointResume:
    def test_save_load_round_trip(self, tmp_path):
        env = penv(1)
        bq = tq.createBatchedQureg(NQ, env, NB)
        for t in range(NQ):
            tq.hadamard(bq, t)
        want = np.asarray(bq.amps)
        tq.saveQureg(bq, str(tmp_path / "bank"))
        q2 = tq.loadQureg(str(tmp_path / "bank"), env)
        assert isinstance(q2, tq.BatchedQureg) and q2.batch_size == NB
        assert np.array_equal(np.asarray(q2.amps), want)

    def test_resumed_run_bit_identical(self, tmp_path):
        env = penv(1)
        gates = _bank_gates(PC, np.random.default_rng(9))
        seeds = [[7 + i] for i in range(NB)]
        bq = tq.createBatchedQureg(NQ, env, NB, seeds=seeds)
        tq.runResumable(bq, gates, str(tmp_path / "ck"), every=4)
        full = np.asarray(bq.amps)
        bq2 = tq.createBatchedQureg(NQ, env, NB, seeds=seeds)
        with pytest.raises(tq.SimulatedPreemption):
            tq.runResumable(bq2, gates, str(tmp_path / "ck2"), every=4,
                            faults=tq.FaultPlan("kill@2"))
        bq3 = tq.createBatchedQureg(NQ, env, NB, seeds=seeds)
        tq.runResumable(bq3, gates, str(tmp_path / "ck2"), every=4)
        assert np.array_equal(full, np.asarray(bq3.amps))
        assert bq3.key_state() == bq.key_state()
        renv = qt.createQuESTEnv(num_devices=1)
        rq = qt.createBatchedQureg(NQ, renv, NB, seeds=seeds)
        qt.run_resumable(rq, _bank_gates(RC, np.random.default_rng(9)),
                         str(tmp_path / "ref"), every=4)
        assert np.abs(full - np.asarray(rq.amps)).max() < TOL

    def test_batched_checkpoint_refuses_scalar_register(self, tmp_path):
        env = penv(1)
        gates = _bank_gates(PC, np.random.default_rng(10), count=8)
        bq = tq.createBatchedQureg(NQ, env, NB)
        tq.runResumable(bq, gates, str(tmp_path / "ck"), every=4)
        with pytest.raises(tq.QuESTError, match="batch mismatch"):
            tq.runResumable(tq.createQureg(NQ, env), gates,
                            str(tmp_path / "ck"), every=4)
        with pytest.raises(tq.QuESTError, match="batch mismatch"):
            tq.runResumable(tq.createBatchedQureg(NQ, env, NB * 2), gates,
                            str(tmp_path / "ck"), every=4)

    @pytest.mark.parametrize("R", [1, 2])
    def test_health_covers_every_element(self, R):
        env = penv(R)
        bq = tq.createBatchedQureg(NQ, env, NB)
        norm, finite = tq.checkQuregHealth(bq)
        assert finite and abs(norm - 1.0) < 1e-12
        bank = np.array(interop.register_state(bq)[0])
        bank[2] *= 2.0
        interop.load_register(bq, bank)
        norm, finite, elem = PR.check_bank_health(bq)
        assert finite and abs(norm - 4.0) < 1e-12 and elem == 2
        bank[1, 0, 3] = np.nan
        interop.load_register(bq, bank)
        norm, finite, elem = PR.check_bank_health(bq)
        assert not finite and elem == 1
        ex = tq.WindowExecutor(bq, [], every=1)
        ex.last_window = (0, 1)
        with pytest.raises(tq.NumericalHealthError) as ei:
            ex.check_health()
        assert ei.value.element == 1
