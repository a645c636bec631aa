"""The serving layer (M16e) in the port against the JAX package.

The classes of tests/test_serve.py, each scenario run through
``quest_tpu.serve.SimServer`` (one device of the suite's CPU mesh) and
``quest_tpu_torch.serve.SimServer`` (``createQuESTEnv(device="cpu")``) on
the same seeded trace at float64 (tests/serve_twin.py): every job's
amplitudes within 1e-10 and equal outcomes, key states and attempts; the
same schedule (step, bank, jobs, cursor), rejections (kind, limit,
value), ``stats()`` and ``serve_*`` counters.  Each test then asserts the
reference test's own contract on the port's run: continuous batching,
admission control, the two classes with weighted fair queuing,
preemption by checkpoint or pause bit for bit the uninterrupted run, the
occupancy accounting, the window executor, the asyncio front end and
the reportPerf section.
"""

import asyncio

import numpy as np
import pytest

import quest_tpu as qt
from quest_tpu import optimizer as ROPT
from quest_tpu import rng as RRNG
from quest_tpu.ops import measurement as RM
import quest_tpu_torch as tq
from quest_tpu_torch import batch as PB
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import governor as PG
from quest_tpu_torch import optimizer as POPT
from quest_tpu_torch import precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import rng as PRNG
from quest_tpu_torch import serve as PS
from quest_tpu_torch import telemetry as PT
from quest_tpu_torch.ops import measurement as PM

from serve_twin import (N, assert_jobs, assert_twins, circ, port_env,
                        twin)


def PS_circ(theta, depth=3):
    return circ(PC, theta, depth)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """float64, the literal gate stream in both packages (window-stepped
    drains suppress the optimizer, so plain-drain yardsticks must be raw
    too), telemetry on, no memory budget, and both packages' streams and
    degradation registries restored afterwards."""
    monkeypatch.setenv("QT_OPTIMIZER", "off")
    for var in ("QT_HBM_BUDGET_BYTES", "QT_MEM_POLICY", "QT_AOT_CACHE",
                "QT_FAULT_PLAN") + tuple(
                    f"QT_SERVE_{k}" for k in (
                        "WINDOW", "MAX_BATCH", "MAX_PENDING", "PREEMPT",
                        "CKPT_DIR", "RETRIES", "QUARANTINE", "WATCHDOG",
                        "FLIGHT_DIR", "PREWARM")):
        monkeypatch.delenv(var, raising=False)
    ROPT.clear_cache()
    POPT._cache.clear()
    old = precision.get_precision()
    tq.set_precision(2)
    PT.configure("on")
    from quest_tpu import governor as RG
    from quest_tpu import telemetry as RT
    RT.configure("on")
    PG.reset()
    RG.reset()
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
    PG.reset()
    RG.reset()
    tq.set_precision(old)


def counters(port):
    return port[2]


class TestSubmitAndResults:
    def test_results_match_ensemble_drain(self, monkeypatch):
        thetas = [0.3 + 0.05 * i for i in range(5)]

        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(t), num_qubits=N, seed=i)
                    for i, t in enumerate(thetas)]
            srv.run_until_idle(max_steps=500)
            sched = s.B.EnsembleScheduler(N, s.env, max_batch=8)
            for t in thetas:
                sched.submit(s.circ(t))
            return {"jobs": jobs, "expected": sched.drain()}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        for job, exp in zip(port[1]["jobs"], port[1]["expected"]):
            assert job.state == PS.DONE
            assert np.array_equal(np.asarray(job.amps), np.asarray(exp))

    def test_result_before_completion_raises(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            job = srv.submit(s.circ(0.1), num_qubits=N)
            with pytest.raises(s.qt.QuESTError, match="before completion"):
                job.result()
            srv.run_until_idle(max_steps=500)
            assert job.result() is job.amps
            return {"jobs": [job]}

        assert_twins(*twin(scenario, monkeypatch=monkeypatch))

    def test_measurement_schedule_runs_per_element_streams(
            self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.4), num_qubits=N, seed=7 + i,
                               measure=(0, 2)) for i in range(3)]
            srv.run_until_idle(max_steps=500)
            # a standalone bank seeded as the server seeds its padded bank
            # (padding repeats the last element) draws the same outcomes
            q = s.B.createBatchedQureg(N, s.env, 4, seeds=[7, 8, 9, 9])
            for g in s.circ(0.4):
                q._fusion.gates.append(g)
            rounds = [s.B.measureBatched(q, t)[0] for t in (0, 2)]
            return {"jobs": jobs, "rounds": rounds}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        jobs, rounds = port[1]["jobs"], port[1]["rounds"]
        for i, job in enumerate(jobs):
            assert len(job.outcomes) == 2
            assert job.key_state["counter"] == 2
            assert [o for o, _ in job.outcomes] == [int(rounds[0][i]),
                                                     int(rounds[1][i])]

    def test_mixed_structures_bucket_separately(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.2, depth=1), num_qubits=N),
                    srv.submit(s.circ(0.2, depth=2), num_qubits=N),
                    srv.submit(s.circ(0.9, depth=1), num_qubits=N)]
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        a, b, c = port[1]["jobs"]
        assert a.state == b.state == c.state == PS.DONE
        assert not np.array_equal(np.asarray(a.amps), np.asarray(b.amps))
        assert counters(port)["serve_banks_total"][""] == 2


class TestContinuousBatching:
    def test_arrival_mid_flight_coalesces_into_next_bank(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            first = srv.submit(s.circ(0.1, depth=6), num_qubits=N)
            srv.step()  # starts bank 0, runs its first window
            late = [srv.submit(s.circ(0.1 + 0.01 * i, depth=6),
                               num_qubits=N) for i in range(3)]
            srv.run_until_idle(max_steps=500)
            return {"jobs": [first] + late}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert all(j.state == PS.DONE for j in port[1]["jobs"])
        # two banks: the one in flight and one for all three arrivals
        assert counters(port)["serve_banks_total"][""] == 2

    def test_open_bank_absorbs_arrivals_before_first_window(
            self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.5), num_qubits=N, seed=i)
                    for i in range(3)]
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs,
                    "occ": s.T.snapshot()["gauges"]["serve_bank_occupancy"]}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert counters(port)["serve_banks_total"][""] == 1
        assert port[1]["occ"] == ref[1]["occ"] == {"": 0.75}

    def test_per_tenant_bank_occupancy_gauge(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.5), num_qubits=N, tenant="a"),
                    srv.submit(s.circ(0.6), num_qubits=N, tenant="a"),
                    srv.submit(s.circ(0.7), num_qubits=N, tenant="b")]
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs,
                    "occ": s.T.snapshot()["gauges"]["bank_occupancy"]}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[1]["occ"] == ref[1]["occ"] == {"tenant=a": 0.5,
                                                    "tenant=b": 0.25}


class TestAdmissionControl:
    def test_global_backpressure(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8, max_pending=2)
            jobs = [s.submit(srv, s.circ(0.1), num_qubits=N),
                    s.submit(srv, s.circ(0.2), num_qubits=N)]
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.3), num_qubits=N)
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[0].rejections == [("default", "backpressure", 2.0,
                                       2.0)]

    def test_tenant_pending_quota(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            srv.register_tenant("small", max_pending=1)
            jobs = [s.submit(srv, s.circ(0.1), num_qubits=N,
                             tenant="small")]
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.2), num_qubits=N, tenant="small")
            jobs.append(s.submit(srv, s.circ(0.2), num_qubits=N,
                                 tenant="other"))
            srv.run_until_idle(max_steps=500)
            jobs.append(s.submit(srv, s.circ(0.3), num_qubits=N,
                                 tenant="small"))
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[0].rejections == [("small", "pending", 1.0, 1.0)]

    def test_tenant_byte_quota_analytic_pricing(self, monkeypatch):
        one = PS._job_bytes_per_device(N, port_env(1), False)
        assert one == 2 * (1 << N) * 8

        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            srv.register_tenant("capped", max_bytes=one)
            jobs = [s.submit(srv, s.circ(0.1), num_qubits=N,
                             tenant="capped")]
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.2), num_qubits=N, tenant="capped")
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[0].rejections == [("capped", "bytes", float(one),
                                       float(2 * one))]

    def test_memory_refusal_prices_like_the_governor(self, monkeypatch):
        """A job that could never fit the budget per device is refused
        with the reference's numbers; on a mesh the job is priced per
        shard, as governor.admit_new prices its register."""
        monkeypatch.setenv("QT_HBM_BUDGET_BYTES", str(1 << 13))

        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [s.submit(srv, s.circ(0.1, depth=1, n=6), num_qubits=6)]
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.1, depth=1, n=11), num_qubits=11)
            srv.run_until_idle(max_steps=100)
            return {"jobs": jobs}

        for R in (1, 2):
            ref, port = twin(scenario, R=R, monkeypatch=monkeypatch)
            assert_twins(ref, port)
            assert port[1]["jobs"][0].state == PS.DONE
            assert port[0].rejections == [
                ("default", "memory", 8192.0, float(2 * 2048 * 8 // R))]
        # the price is the governor's for the register the bank creates
        env = port_env(2)
        q = PB.createBatchedQureg(6, env, 1)
        assert PG.register_bytes_per_device(q) == \
            PS._job_bytes_per_device(6, env, False)

    def test_rejections_are_counted(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8, max_pending=1)
            jobs = [s.submit(srv, s.circ(0.1), num_qubits=N, tenant="t")]
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.2), num_qubits=N, tenant="t")
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert counters(port)["serve_jobs_rejected_total"] == {
            "kind=backpressure,tenant=t": 1.0}


class TestScheduling:
    def test_interactive_runs_before_batch_backlog(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            long_jobs = [srv.submit(s.circ(0.1 + i, depth=8), num_qubits=N)
                         for i in range(2)]
            vip = srv.submit(s.circ(0.9, depth=1), num_qubits=N,
                             priority=s.S.INTERACTIVE, tenant="vip")
            steps = 0
            while not vip.done and steps < 50:
                srv.step()
                steps += 1
            pending = [j.done for j in long_jobs]
            srv.run_until_idle(max_steps=500)
            return {"jobs": long_jobs + [vip], "pending": pending}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert not all(port[1]["pending"])
        assert all(j.state == PS.DONE for j in port[1]["jobs"])

    def test_weighted_fair_shares_windows(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=2, max_batch=2)
            srv.register_tenant("heavy", weight=4.0)
            srv.register_tenant("light", weight=1.0)
            jobs = []
            for i in range(4):
                jobs.append(srv.submit(s.circ(0.1 * i, depth=4),
                                       num_qubits=N, tenant="heavy"))
                jobs.append(srv.submit(s.circ(0.1 * i, depth=5),
                                       num_qubits=N, tenant="light"))
            srv.run_until_idle(max_steps=1000)
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        h = port[0].servers[0].tenants["heavy"]
        li = port[0].servers[0].tenants["light"]
        assert h.completed == li.completed == 4
        assert h.vtime < li.vtime

    def test_vtime_catches_up_after_idle(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            srv.register_tenant("busy")
            jobs = [srv.submit(s.circ(0.2 * i, depth=4), num_qubits=N,
                               tenant="busy") for i in range(3)]
            srv.run_until_idle(max_steps=500)
            busy_vt = srv.tenants["busy"].vtime
            jobs.append(srv.submit(s.circ(0.7), num_qubits=N,
                                   tenant="newcomer"))
            return {"jobs": jobs, "busy": busy_vt,
                    "newcomer": srv.tenants["newcomer"].vtime}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[1]["busy"] == ref[1]["busy"] > 0
        assert port[1]["newcomer"] == ref[1]["newcomer"] >= port[1]["busy"]


def _long_job(s, interrupt: bool, mode="checkpoint"):
    """One long batch job, optionally interrupted by an interactive burst
    after 3 windows."""
    srv = s.server(window=4, max_batch=8, preempt=mode)
    job = srv.submit(s.circ(0.5, depth=6), num_qubits=N, tenant="batchy",
                     seed=11, measure=(0, 2))
    for _ in range(3):
        srv.step()
    burst = []
    if interrupt:
        burst = [srv.submit(s.circ(1.5, depth=1), num_qubits=N,
                            tenant="vip", seed=40 + i,
                            priority=s.S.INTERACTIVE) for i in range(2)]
        while not all(b.done for b in burst):
            srv.step()
    srv.run_until_idle(max_steps=500)
    return {"jobs": [job] + burst}


class TestPreemption:
    def _check(self, monkeypatch, mode):
        ref_a, port_a = twin(lambda s: _long_job(s, False, mode),
                             monkeypatch=monkeypatch)
        ref_b, port_b = twin(lambda s: _long_job(s, True, mode),
                             monkeypatch=monkeypatch)
        assert_twins(ref_a, port_a)
        assert_twins(ref_b, port_b)
        a, b = port_a[1]["jobs"][0], port_b[1]["jobs"][0]
        assert all(j.state == PS.DONE for j in port_b[1]["jobs"])
        # bit for bit the uninterrupted run: amplitudes, outcomes and
        # their probabilities, the key bank and the shot counter
        assert np.array_equal(np.asarray(a.amps), np.asarray(b.amps))
        assert a.outcomes == b.outcomes
        assert a.key_state == b.key_state
        return counters(port_b)

    def test_preempt_to_checkpoint_resume_bit_identical(self, monkeypatch):
        c = self._check(monkeypatch, "checkpoint")
        assert c["preemptions_total"]["mode=checkpoint"] >= 1
        assert c["serve_resumes_total"][""] >= 1

    def test_pause_mode_is_also_bit_identical(self, monkeypatch):
        c = self._check(monkeypatch, "pause")
        assert c["preemptions_total"]["mode=pause"] >= 1
        assert "serve_resumes_total" not in c

    def test_preempt_off_disables_preemption(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8, preempt="off")
            jobs = [srv.submit(s.circ(0.5, depth=6), num_qubits=N)]
            srv.step()
            jobs.append(srv.submit(s.circ(1.5, depth=1), num_qubits=N,
                                   priority=s.S.INTERACTIVE))
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert "preemptions_total" not in counters(port)

    def test_refused_start_checkpoints_a_resident_batch_bank(
            self, monkeypatch):
        """_preempt_for_memory: a bank whose register is refused beside a
        resident batch bank stalls, the resident bank is checkpointed,
        the start succeeds on the next step, and every job equals its
        run without the refusal."""
        def scenario(s, refuse):
            srv = s.server(window=4, max_batch=8)
            srv.register_tenant("a", weight=1.0)
            srv.register_tenant("b", weight=3.0)
            real = s.B.createBatchedQureg

            def guarded(*a, **k):
                if refuse and any(b.qureg is not None for b in srv._banks):
                    refuse.pop()
                    raise s.qt.MemoryAdmissionError(
                        "createBatchedQureg", 1 << 20, 1 << 10, 1 << 20)
                return real(*a, **k)

            monkeypatch.setattr(s.B, "createBatchedQureg", guarded)
            jobs = [srv.submit(s.circ(0.2 + 0.1 * i, depth=6),
                               num_qubits=N, tenant="a", seed=i,
                               measure=(0, 2)) for i in range(2)]
            jobs += [srv.submit(s.circ(0.5 + 0.1 * i, depth=5),
                                num_qubits=N, tenant="b", seed=10 + i,
                                measure=(1,)) for i in range(3)]
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs}

        _ref, calm = twin(lambda s: scenario(s, []),
                          monkeypatch=monkeypatch)
        ref, port = twin(lambda s: scenario(s, [True]),
                         monkeypatch=monkeypatch)
        assert_twins(ref, port)
        c = counters(port)
        assert c["serve_admission_stalls_total"] == {"": 1.0}
        assert c["preemptions_total"] == {"mode=checkpoint": 1.0}
        for a, b in zip(port[1]["jobs"], calm[1]["jobs"]):
            assert a.state == PS.DONE
            assert np.array_equal(np.asarray(a.amps), np.asarray(b.amps))
            assert a.outcomes == b.outcomes and a.key_state == b.key_state

    def test_preempt_checkpoint_releases_the_device_bank(
            self, monkeypatch):
        """The preempted bank's register leaves the governor's ledger and
        the server holds no reference to it, so its memory is freed."""
        import gc
        import weakref

        srv = PS.SimServer(port_env(1), window=4, max_batch=8)
        try:
            srv.submit(PS_circ(0.5, depth=6), num_qubits=N)
            srv.step()
            (bank,) = srv._banks
            ref = weakref.ref(bank.qureg)
            before = PG.resident_bytes()
            assert before == 2 * (1 << N) * 8
            srv.submit(PS_circ(1.5, depth=1), num_qubits=N,
                       priority=PS.INTERACTIVE)
            srv.step()
            gc.collect()
            assert bank.preempted and bank.qureg is None
            assert ref() is None
            srv.run_until_idle(max_steps=500)
        finally:
            srv.close()
        assert PG.resident_bytes() == 0


class TestOccupancyAccounting:
    def test_drain_gauge_aggregates_across_buckets(self, monkeypatch):
        def scenario(s):
            sched = s.B.EnsembleScheduler(N, s.env, max_batch=8)
            for i in range(5):
                sched.submit(s.circ(0.1 * i))
            sched.submit(s.circ(0.9, depth=1))
            sched.drain()
            snap = s.T.snapshot()
            return {"jobs": [],
                    "gauge": snap["gauges"]["batch_occupancy"][""],
                    "count": snap["histograms"][
                        "ensemble_bucket_occupancy"][""]["count"]}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert port[1]["gauge"] == ref[1]["gauge"] == pytest.approx(6 / 9)
        assert port[1]["count"] == ref[1]["count"] == 2

    def test_bank_occupancy_with_real_count(self):
        class Fake:
            batch_size = 8

        occ = PB.bank_occupancy(Fake(), real=5)
        assert occ == {"size": 5, "bucket": 8, "occupancy": 5 / 8}


class TestWindowExecutor:
    def test_executor_matches_monolithic_drain(self, monkeypatch):
        def scenario(s):
            gates = s.circ(0.3, depth=5)
            q1 = s.qt.createQureg(N, s.env)
            q2 = s.qt.createQureg(N, s.env)
            s.qt.startGateFusion(q1)
            for g in gates:
                q1._fusion.gates.append(g)
            s.qt.stopGateFusion(q1)
            ex = s.R.WindowExecutor(q2, gates, every=7)
            windows = 0
            while not ex.done:
                ex.step()
                windows += 1
            assert windows == ex.num_windows
            assert ex.cursor == len(gates)
            return {"jobs": [], "a": np.asarray(q1.amps),
                    "b": np.asarray(q2.amps), "windows": windows}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert np.array_equal(port[1]["a"], port[1]["b"])
        assert port[1]["windows"] == ref[1]["windows"]
        assert np.abs(port[1]["b"] - ref[1]["b"]).max() <= 1e-10

    def test_checkpoint_resume_midstream(self, monkeypatch, tmp_path):
        def scenario(s):
            root = tmp_path / s.name
            gates = s.circ(0.3, depth=5)
            q1 = s.qt.createQureg(N, s.env)
            ex = s.R.WindowExecutor(q1, gates, every=7, fingerprint="fp-t")
            ex.step()
            ex.step()
            ex.checkpoint(str(root))
            cursor = ex.cursor
            q2, meta = s.R.load_latest(str(root), s.env)
            assert int(meta["cursor"]) == cursor
            ex2 = s.R.WindowExecutor(q2, gates, every=7, start=cursor)
            while not ex2.done:
                ex2.step()
            while not ex.done:
                ex.step()
            return {"jobs": [], "a": np.asarray(q1.amps),
                    "b": np.asarray(q2.amps), "cursor": cursor}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert np.array_equal(port[1]["a"], port[1]["b"])
        assert port[1]["cursor"] == ref[1]["cursor"]
        assert np.abs(port[1]["b"] - ref[1]["b"]).max() <= 1e-10


class TestAsyncService:
    def test_async_submit_and_wait(self, monkeypatch):
        def scenario(s):
            async def main():
                srv = s.server(window=4, max_batch=8)
                async with s.S.Service(srv, idle_sleep=0.0005) as svc:
                    jobs = [await svc.submit(
                        s.circ(0.2 + 0.1 * i), num_qubits=N, seed=i)
                        for i in range(3)]
                    return [await svc.wait(j) for j in jobs]

            return {"jobs": asyncio.run(main())}

        ref, port = twin(scenario)
        assert [j.state for j in port[1]["jobs"]] == [PS.DONE] * 3
        # the loop steps between awaits, so the schedule may differ from
        # the reference's; the results may not
        assert_jobs(ref[1]["jobs"], port[1]["jobs"])

    def test_async_quota_error_propagates(self):
        async def main():
            srv = PS.SimServer(port_env(1), window=4, max_batch=8,
                               max_pending=1)
            try:
                async with PS.Service(srv) as svc:
                    job = await svc.submit(PS_circ(0.1), num_qubits=N)
                    with pytest.raises(PS.QuotaExceededError) as ei:
                        await svc.submit(PS_circ(0.2), num_qubits=N)
                    assert ei.value.kind == "backpressure"
                    return await svc.wait(job)
            finally:
                srv.close()

        assert asyncio.run(main()).state == PS.DONE


class TestReportPerf:
    def test_serving_section_in_perf_report(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.3), num_qubits=N, tenant="acme")]
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs, "report": s.T.perf_report()}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        report = port[1]["report"]
        assert "serving (continuous batcher):" in report
        assert "jobs: submitted=1 completed=1" in report
        assert "queue_wait_seconds:" in report

        def section(text):
            lines = text.splitlines()
            i = lines.index("serving (continuous batcher):")
            return [ln for ln in lines[i:i + 3]
                    if "seconds" not in ln]

        assert section(report) == section(ref[1]["report"])

    def test_stats_snapshot(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8)
            jobs = [srv.submit(s.circ(0.3), num_qubits=N, tenant="acme")]
            before = srv.stats()
            srv.run_until_idle(max_steps=500)
            return {"jobs": jobs, "before": before}

        ref, port = twin(scenario, monkeypatch=monkeypatch)
        assert_twins(ref, port)
        assert port[1]["before"] == ref[1]["before"]
        assert port[1]["before"]["queued"] == 1
        assert port[1]["before"]["tenants"]["acme"]["inflight"] == 1
        st = port[0].stats[0]
        assert st["completed"] == 1
        assert st["tenants"]["acme"]["inflight"] == 0


class TestServerLifecycle:
    def test_submit_after_close_raises(self):
        srv = PS.SimServer(port_env(1))
        srv.close()
        with pytest.raises(tq.QuESTError, match="close"):
            srv.submit(PS_circ(0.1), num_qubits=N)

    def test_config_validation(self):
        env = port_env(1)
        with pytest.raises(tq.QuESTError, match="power of two"):
            PS.SimServer(env, max_batch=3)
        with pytest.raises(tq.QuESTError, match="window"):
            PS.SimServer(env, window=0)
        with pytest.raises(tq.QuESTError, match="preempt"):
            PS.SimServer(env, preempt="sometimes")

    def test_env_knobs(self, monkeypatch):
        monkeypatch.setenv("QT_SERVE_WINDOW", "9")
        monkeypatch.setenv("QT_SERVE_MAX_BATCH", "32")
        monkeypatch.setenv("QT_SERVE_PREEMPT", "pause")
        monkeypatch.setenv("QT_SERVE_RETRIES", "5")
        monkeypatch.setenv("QT_SERVE_QUARANTINE", "4:12.5")
        monkeypatch.setenv("QT_SERVE_WATCHDOG", "3")
        monkeypatch.setenv("QT_SERVE_MAX_PENDING", "77")
        srv = PS.SimServer(port_env(1))
        ref = qt.serve.SimServer(qt.createQuESTEnv(num_devices=1))
        try:
            for s in (srv, ref):
                assert s.window == 9
                assert s.max_batch == 32
                assert s.preempt == "pause"
                assert s.retries == 5
                assert (s._q_threshold, s._q_open_seconds) == (4, 12.5)
                assert s.watchdog == 3
                assert s.max_pending == 77
        finally:
            srv.close()
            ref.close()

    def test_defaults_are_the_references(self):
        srv = PS.SimServer(port_env(1))
        ref = qt.serve.SimServer(qt.createQuESTEnv(num_devices=1))
        try:
            for attr in ("window", "max_batch", "max_pending", "preempt",
                         "retries", "_q_threshold", "_q_open_seconds",
                         "watchdog", "prewarm"):
                assert getattr(srv, attr) == getattr(ref, attr), attr
        finally:
            srv.close()
            ref.close()
        assert [PS.INTERACTIVE, PS.BATCH] == [qt.serve.INTERACTIVE,
                                              qt.serve.BATCH]
        assert sorted(PS.__all__) == sorted(qt.serve.__all__)

    def test_context_manager_closes(self):
        with PS.SimServer(port_env(1), window=4) as srv:
            srv.submit(PS_circ(0.1), num_qubits=N)
            srv.step()
            assert srv._banks
        assert srv._closed and not srv._banks
        assert PG.resident_bytes() == 0

    def test_exports(self):
        assert tq.SimServer is PS.SimServer
        assert tq.SimService is PS.Service
        assert tq.Service is PS.Service
        assert tq.Job is PS.Job and tq.Tenant is PS.Tenant
        assert tq.QuotaExceededError is PS.QuotaExceededError
        assert tq.serve is PS
        assert tq.WindowExecutor is not None
