"""The serving layer's fault tolerance and observability (M16e) in the
port against the JAX package.

The classes of tests/test_serve_resilience.py but its lint-vocabulary
pin (a rule of ``analysis/``, ROADMAP M16f), each scenario run through
both packages' SimServer on the same seeded trace and FaultPlan at
float64 (tests/serve_twin.py): one device for retries and quarantine,
the suite's 8-device mesh and an in-process mesh of 8 CPU shards for
failover and heal.  Every job's amplitudes agree within 1e-10, and its
outcomes, attempts, key state and error chain, each server's schedule,
rejections and ``stats()``, and the ``serve_*`` counters are equal.  The
reference test's own contract is then asserted on the port's run.

``TestChaos`` ports scripts/chaos_serve.py's invariants (a)-(f) for two
seeds on the port alone (a chaos arm against its fault-free replay).
Invariant (g), the warm pool one failover ahead, needs the persistent
plan cache of ROADMAP M16f and is not checked.
"""

import asyncio
import json
import urllib.error
import urllib.request

import numpy as np
import pytest

import quest_tpu as qt
from quest_tpu import governor as RG
from quest_tpu import optimizer as ROPT
from quest_tpu import resilience as RR
from quest_tpu import rng as RRNG
from quest_tpu import telemetry as RT
from quest_tpu.ops import measurement as RM
import quest_tpu_torch as tq
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import governor as PG
from quest_tpu_torch import optimizer as POPT
from quest_tpu_torch import precision
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import rng as PRNG
from quest_tpu_torch import serve as PS
from quest_tpu_torch import telemetry as PT
from quest_tpu_torch.ops import measurement as PM

from serve_twin import N, assert_twins, circ, port_env, twin

JITTER = (20260805,)


@pytest.fixture(autouse=True)
def _setup(monkeypatch):
    """float64, the literal gate stream, millisecond backoff with the
    reference fixture's pinned jitter seed, telemetry on, no budget, and
    both packages' streams and registries restored afterwards."""
    monkeypatch.setenv("QT_OPTIMIZER", "off")
    monkeypatch.setenv("QT_RETRY_BASE_SECONDS", "0.001")
    for var in ("QT_HBM_BUDGET_BYTES", "QT_MEM_POLICY", "QT_AOT_CACHE",
                "QT_FAULT_PLAN", "QT_TOPOLOGY", "QT_SERVE_FLIGHT_DIR",
                "QT_SERVE_CKPT_DIR", "QT_SERVE_PREWARM"):
        monkeypatch.delenv(var, raising=False)
    ROPT.clear_cache()
    POPT._cache.clear()
    old = precision.get_precision()
    tq.set_precision(2)
    PT.configure("on")
    RT.configure("on")
    PG.reset()
    RG.reset()
    RR.seed_backoff_jitter(list(JITTER))
    PR.seed_backoff_jitter(list(JITTER))
    states = (RRNG.GLOBAL_RNG.get_state(), RM.KEYS.get_state(),
              PRNG.GLOBAL_RNG.get_state(), PM.KEYS.get_state())
    degr = (dict(RR.DEGRADATIONS), dict(PR.DEGRADATIONS))
    yield
    RRNG.GLOBAL_RNG.set_state(states[0])
    RM.KEYS.set_state(states[1])
    PRNG.GLOBAL_RNG.set_state(states[2])
    PM.KEYS.set_state(states[3])
    for reg, saved in zip((RR.DEGRADATIONS, PR.DEGRADATIONS), degr):
        reg.clear()
        reg.update(saved)
    RR._JITTER_RNG[0] = None
    PR._JITTER_RNG[0] = None
    PG.reset()
    RG.reset()
    tq.set_precision(old)


def _snapshot(job):
    return {
        "amps": np.asarray(job.amps).tobytes(),
        "outcomes": tuple(job.outcomes),
        "key": np.asarray(job.key_state["key"]).tobytes(),
        "counter": int(job.key_state["counter"]),
    }


def _trace(thetas, faults="", measure=(0, 2), **kw):
    """The scenario of one deterministic trace drained by one server."""
    def scenario(s):
        srv = s.server(window=4, max_batch=8, faults=faults, **kw)
        jobs = [srv.submit(s.circ(t), num_qubits=N, seed=100 + i,
                           measure=measure)
                for i, t in enumerate(thetas)]
        srv.run_until_idle(max_steps=800)
        return {"jobs": jobs, "plan": srv.faults}

    return scenario


def _twin(monkeypatch, scenario, R=1):
    return twin(scenario, R=R, monkeypatch=monkeypatch, jitter=JITTER)


def counters(side):
    return side[2]


class TestBackoffJitter:
    def test_envelope(self):
        base = 0.01
        prev = None
        for _ in range(50):
            d = PR.backoff_delay(base, prev)
            lo, hi = base, max(base, min(64 * base, 3 * (prev or base)))
            assert lo <= d <= hi
            prev = d

    def test_cap_at_64x_base(self):
        d = 0.01
        for _ in range(100):
            d = PR.backoff_delay(0.01, d)
            assert d <= 64 * 0.01

    def test_deterministic_under_seed_and_the_references_stream(self):
        def draws(R, seed, prev=None):
            R.seed_backoff_jitter([seed])
            out = []
            for _ in range(10):
                prev = R.backoff_delay(0.01, prev)
                out.append(prev)
            return out

        assert draws(PR, 7) == draws(PR, 7) != draws(PR, 8)
        # the same delays as the JAX package for the same seed
        assert draws(PR, 7) == draws(RR, 7)
        assert draws(PR, 20260805) == draws(RR, 20260805)

    def test_chaos_seed_env_pins_stream(self, monkeypatch):
        monkeypatch.setenv(PR._CHAOS_SEED_ENV, "424242")
        PR.seed_backoff_jitter()
        a = [PR.backoff_delay(0.01, None) for _ in range(5)]
        PR.seed_backoff_jitter()
        assert a == [PR.backoff_delay(0.01, None) for _ in range(5)]

    def test_jitter_stream_is_not_the_measurement_stream(self):
        PR.backoff_delay(0.01, None)
        assert PR._JITTER_RNG[0] is not None
        assert PR._JITTER_RNG[0] is not PRNG.GLOBAL_RNG

    def test_retry_io_sleeps_jittered_not_ladder(self, monkeypatch):
        def sleeps_of(R):
            sleeps = []
            monkeypatch.setattr(R.time, "sleep", sleeps.append)
            R._ACTIVE_FAULTS[0] = R.FaultPlan("io@3")
            try:
                R.seed_backoff_jitter([99])
                assert R.retry_io(lambda: "ok", attempts=4,
                                  base_delay=0.001) == "ok"
            finally:
                R._ACTIVE_FAULTS[0] = None
            return sleeps

        sleeps = sleeps_of(PR)
        assert len(sleeps) == 3
        assert sleeps != [0.001, 0.002, 0.004]
        prev = None
        for d in sleeps:
            assert 0.001 <= d <= max(0.001, 3 * (prev or 0.001))
            prev = d
        assert sleeps_of(PR) == sleeps == sleeps_of(RR)


class TestServeFaultHooks:
    def test_take_serve_fault_fires_once_loss_first(self):
        spec = "bank_fault@2,heal@2,shard_loss@2,host_loss@5,oom@2"
        for R in (PR, RR):
            p = R.FaultPlan(spec)
            got = [p.take_serve_fault(s) for s in range(7)]
            assert got == [None, None, "shard_loss", None, None,
                           "host_loss", None]
            assert p.take_serve_fault(2) == "bank_fault"
            assert p.take_serve_fault(2) == "heal"
            assert p.take_serve_fault(2) is None
        assert PR.FaultPlan(spec).log == []

    def test_poisoned_is_not_consumed(self):
        p = PR.FaultPlan("poison_job@3,poison_job@5")
        for _ in range(3):
            assert p.poisoned(3) and p.poisoned(5) and not p.poisoned(4)
        assert p.poisoned_jobs == RR.FaultPlan(
            "poison_job@3,poison_job@5").poisoned_jobs


class TestTransientRetry:
    THETAS = (0.3, 0.45, 0.6)

    def test_bank_fault_dissolves_and_completes_bit_identical(
            self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS))
        ref, port = _twin(monkeypatch,
                          _trace(self.THETAS, faults="bank_fault@1"))
        assert_twins(ref, port)
        assert counters(port)["serve_bank_retries_total"][
            "reason=transient"] >= 1
        for b, j in zip(base[1]["jobs"], port[1]["jobs"]):
            assert j.state == PS.DONE
            assert j.attempts == 2
            assert j.errors and "injected bank fault" in j.errors[0]
            assert _snapshot(j) == _snapshot(b)
        assert port[0].stats[0]["queued"] == 0
        assert port[0].stats[0]["banks"] == 0

    def test_retry_gated_behind_backoff(self, monkeypatch):
        ref, port = _twin(monkeypatch,
                          _trace(self.THETAS, faults="bank_fault@1"))
        assert_twins(ref, port)
        backs = [j.backoff for j in port[1]["jobs"]]
        assert all(b is not None and b >= 0.001 for b in backs)
        assert backs == [j.backoff for j in ref[1]["jobs"]]

    def test_exhaustion_fails_with_error_chain(self, monkeypatch):
        ref, port = _twin(monkeypatch, _trace(
            (0.3,), faults="bank_fault@1", retries=0))
        assert_twins(ref, port)
        (job,) = port[1]["jobs"]
        assert job.state == PS.FAILED
        assert job.attempts == 1 and len(job.errors) == 1
        with pytest.raises(PS.JobFailedError) as ei:
            job.result()
        err = ei.value
        assert err.tenant == "default" and err.jid == job.id
        assert err.attempts == 1
        assert isinstance(err.cause, TimeoutError)
        assert err.__cause__ is err.cause
        with pytest.raises(PS.JobFailedError) as ei2:
            job.result()
        assert ei2.value is not err and ei2.value.cause is err.cause
        assert port[0].stats[0]["queued"] == 0

    def test_service_wait_raises_jobfailederror(self):
        async def main():
            srv = PS.SimServer(port_env(1), window=4, max_batch=8,
                               retries=0,
                               faults=PR.FaultPlan("bank_fault@1"))
            try:
                async with PS.Service(srv, idle_sleep=0.0005) as svc:
                    job = await svc.submit(circ(PC, 0.3), num_qubits=N)
                    with pytest.raises(PS.JobFailedError) as ei:
                        await svc.wait(job)
                    return ei.value
            finally:
                srv.close()

        assert isinstance(asyncio.run(main()).cause, TimeoutError)

    def test_io_fault_on_preemption_is_absorbed(self, monkeypatch):
        """io@N faults are taken by the preemption checkpoint's retry_io:
        the burst preempts through them and every job completes as
        uninterrupted."""
        def scenario(s):
            srv = s.server(window=4, max_batch=8, faults="io@2")
            job = srv.submit(s.circ(0.5, depth=6), num_qubits=N, seed=11,
                             measure=(0, 2))
            for _ in range(2):
                srv.step()
            burst = srv.submit(s.circ(1.5, depth=1), num_qubits=N,
                               seed=40, priority=s.S.INTERACTIVE)
            srv.run_until_idle(max_steps=500)
            return {"jobs": [job, burst], "log": list(srv.faults.log)}

        ref, port = _twin(monkeypatch, scenario)
        assert_twins(ref, port)
        assert port[1]["log"] == ref[1]["log"] == ["io", "io"]
        assert counters(port)["preemptions_total"]["mode=checkpoint"] == 1


class TestPoisonQuarantine:
    THETAS = (0.2, 0.35, 0.5, 0.65)

    def test_worst_element_attribution_quarantines_culprit(
            self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS, watchdog=1))
        poison_id = base[1]["jobs"][2].id
        ref, port = _twin(monkeypatch, _trace(
            self.THETAS, watchdog=1, faults=f"poison_job@{poison_id}"))
        assert_twins(ref, port)
        jobs = port[1]["jobs"]
        assert jobs[2].id == poison_id and jobs[2].state == PS.FAILED
        with pytest.raises(PS.JobFailedError) as ei:
            jobs[2].result()
        assert isinstance(ei.value.cause, PR.NumericalHealthError)
        for k in (0, 1, 3):
            assert jobs[k].state == PS.DONE
            assert _snapshot(jobs[k]) == _snapshot(base[1]["jobs"][k])
        c = counters(port)
        assert c["serve_jobs_quarantined_total"] == {"tenant=default": 1.0}
        assert c["serve_bank_retries_total"]["reason=poison"] >= 1
        assert port[0].stats[0]["queued"] == 0
        assert port[0].stats[0]["banks"] == 0

    def test_health_error_carries_worst_element(self):
        from quest_tpu_torch import batch as PB

        q = PB.createBatchedQureg(N, port_env(1), 4, seeds=[1, 2, 3, 4])
        q._amps_raw()[2, 0, 3] = float("nan")
        norm, finite, elem = PR.check_bank_health(q)
        assert not finite and elem == 2

    def test_repeated_oom_bisects_blind_and_all_complete(
            self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS))
        # two armed events burn the OOM net's one retry: the verdict is a
        # repeated allocator failure with no element attribution: halve
        ref, port = _twin(monkeypatch,
                          _trace(self.THETAS, faults="oom@1,oom@1"))
        assert_twins(ref, port)
        for b, j in zip(base[1]["jobs"], port[1]["jobs"]):
            assert j.state == PS.DONE
            assert _snapshot(j) == _snapshot(b)
        assert counters(port)["serve_bank_retries_total"][
            "reason=poison"] >= 1
        assert port[0].stats[0]["queued"] == 0

    def test_real_allocator_failure_bisects_other_errors_propagate(
            self, monkeypatch):
        """torch.OutOfMemoryError out of a drain (a RuntimeError) is
        classified as the reference classifies RESOURCE_EXHAUSTED; any
        other RuntimeError propagates out of step()."""
        from quest_tpu_torch import fusion as PF

        PT.reset()
        srv = PS.SimServer(port_env(1), window=4, max_batch=8)
        calls = {"n": 0}
        real = PF.stop_gate_fusion

        def boom(q):
            calls["n"] += 1
            if calls["n"] == 1:
                q._fusion.gates.clear()
                raise torch_oom("CUDA out of memory. Tried to allocate")
            return real(q)

        try:
            jobs = [srv.submit(circ(PC, t), num_qubits=N, seed=i)
                    for i, t in enumerate((0.1, 0.2))]
            monkeypatch.setattr(PF, "stop_gate_fusion", boom)
            srv.run_until_idle(max_steps=200)
            assert [j.state for j in jobs] == [PS.DONE, PS.DONE]
            assert PT.counter_sum("serve_bank_retries_total",
                                  reason="poison") == 1
            bad = srv.submit(circ(PC, 0.3), num_qubits=N)

            def bug(q):
                raise RuntimeError("an unrelated failure")

            monkeypatch.setattr(PF, "stop_gate_fusion", bug)
            with pytest.raises(RuntimeError, match="unrelated"):
                srv.step()
            assert bad.state == PS.RUNNING
        finally:
            monkeypatch.setattr(PF, "stop_gate_fusion", real)
            srv.close()

    def test_breaker_lifecycle_unit(self):
        br = PS._Breaker(2, 30.0)
        assert br.admits() and br.state == "closed"
        br.record_failure()
        assert br.admits()
        br.record_failure()
        assert br.state == "open" and not br.admits()
        br.open_seconds = 0.0
        assert br.admits()
        assert br.state == "half_open"
        assert not br.admits()
        br.record_success()
        assert br.state == "closed" and br.admits()
        br.record_failure()
        br.record_failure()
        br.open_seconds = 0.0
        assert br.admits()
        br.record_failure()
        assert br.state == "open"

    def test_quarantine_opens_breaker_per_tenant_structure(
            self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8, watchdog=1,
                           quarantine=(1, 3600.0))
            bad = srv.submit(s.circ(0.4), num_qubits=N, tenant="eve")
            srv.faults = s.plan(f"poison_job@{bad.id}")
            srv.run_until_idle(max_steps=400)
            with pytest.raises(s.S.QuotaExceededError):
                s.submit(srv, s.circ(0.4), num_qubits=N, tenant="eve")
            ok = srv.submit(s.circ(0.4), num_qubits=N, tenant="bob")
            ok2 = srv.submit(s.circ(0.4, depth=1), num_qubits=N,
                             tenant="eve")
            srv.faults = None
            srv.run_until_idle(max_steps=400)
            (br,) = [b for (t, _k), b in srv._breakers.items()
                     if t == "eve"]
            br.open_seconds = 0.0
            probe = srv.submit(s.circ(0.4), num_qubits=N, tenant="eve")
            srv.run_until_idle(max_steps=400)
            return {"jobs": [bad, ok, ok2, probe], "breaker": br.state}

        ref, port = _twin(monkeypatch, scenario)
        assert_twins(ref, port)
        bad, ok, ok2, probe = port[1]["jobs"]
        assert bad.state == PS.FAILED
        assert port[0].rejections == [("eve", "quarantine", 1.0, 1.0)]
        assert ok.state == ok2.state == probe.state == PS.DONE
        assert port[1]["breaker"] == "closed"


def _assert_close(job, base, tol=1e-13):
    """A job that ran windows on the shrunk mesh against its fault-free
    run: within ``tol`` (the reference's test bound at float64), outcomes
    equal."""
    assert np.abs(np.asarray(job.amps) - np.asarray(base.amps)).max() \
        <= tol
    assert [o for o, _p in job.outcomes] == [o for o, _p in base.outcomes]
    assert np.allclose([p for _o, p in job.outcomes],
                       [p for _o, p in base.outcomes], rtol=0, atol=tol)


class TestFailoverHeal:
    THETAS = (0.25, 0.4, 0.55, 0.7, 0.85)

    def test_host_loss_then_heal_all_complete(self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS), R=8)
        ref, port = _twin(monkeypatch, _trace(
            self.THETAS, faults="host_loss@3,heal@6"), R=8)
        assert_twins(ref, port)
        for b, j in zip(base[1]["jobs"], port[1]["jobs"]):
            assert j.state == PS.DONE
            _assert_close(j, b)
        st = port[0].stats[0]
        assert not st["degraded"] and st["devices"] == 8
        c = counters(port)
        assert c["serve_failovers_total"] == {"": 1.0}
        assert c["serve_heals_total"] == {"": 1.0}
        assert PT.gauge_max("serve_degraded") == 0.0
        assert PT.gauge_max("serve_failover_mttr_seconds") is not None

    def test_post_heal_results_bit_identical(self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS), R=8)

        def scenario(s):
            srv = s.server(window=4, max_batch=8,
                           faults="host_loss@0,heal@1")
            for _ in range(2):
                srv.step()
            assert srv.stats()["devices"] == 8
            assert not srv.stats()["degraded"]
            jobs = [srv.submit(s.circ(t), num_qubits=N, seed=100 + i,
                               measure=(0, 2))
                    for i, t in enumerate(self.THETAS)]
            srv.run_until_idle(max_steps=800)
            return {"jobs": jobs}

        ref, port = _twin(monkeypatch, scenario, R=8)
        assert_twins(ref, port)
        for b, j in zip(base[1]["jobs"], port[1]["jobs"]):
            assert j.state == PS.DONE
            assert _snapshot(j) == _snapshot(b)

    def test_degraded_serving_without_heal_still_completes(
            self, monkeypatch):
        _r, base = _twin(monkeypatch, _trace(self.THETAS), R=8)
        ref, port = _twin(monkeypatch, _trace(
            self.THETAS, faults="shard_loss@2"), R=8)
        assert_twins(ref, port)
        for b, j in zip(base[1]["jobs"], port[1]["jobs"]):
            assert j.state == PS.DONE
            _assert_close(j, b)
        st = port[0].stats[0]
        assert st["degraded"] and st["devices"] == 4
        assert PT.gauge_max("serve_degraded") == 1.0

    def test_host_aware_exclusion_on_a_2x4_topology(self, monkeypatch):
        """Under QT_TOPOLOGY=2x4 a host loss drops the dead host's whole
        range (shards 4-7) and heal regrows the 2x4 arrangement."""
        monkeypatch.setenv("QT_TOPOLOGY", "2x4")

        def scenario(s):
            srv = s.server(window=4, max_batch=8,
                           faults="host_loss@2,heal@5")
            jobs = [srv.submit(s.circ(t), num_qubits=N, seed=100 + i)
                    for i, t in enumerate(self.THETAS)]
            srv.step()
            srv.step()
            srv.step()
            degraded = (srv.env.num_devices, srv.env.topology.hosts)
            srv.run_until_idle(max_steps=800)
            return {"jobs": jobs, "degraded": degraded,
                    "healed": srv.env.topology.hosts}

        ref, port = _twin(monkeypatch, scenario, R=8)
        assert_twins(ref, port)
        assert port[1]["degraded"][0] == ref[1]["degraded"][0] == 4
        assert port[1]["degraded"][1] == ref[1]["degraded"][1] == 1
        assert port[1]["healed"] == ref[1]["healed"] == 2

    def test_heal_is_idempotent_when_not_degraded(self):
        srv = PS.SimServer(port_env(8), window=4, max_batch=8)
        try:
            assert srv.heal() is False
        finally:
            srv.close()

    def test_failover_reprices_admission_on_live_env(self, monkeypatch):
        def scenario(s):
            srv = s.server(window=4, max_batch=8, faults="shard_loss@1")
            before = s.S._job_bytes_per_device(N, srv.env, False)
            jobs = [srv.submit(s.circ(0.3), num_qubits=N)]
            srv.run_until_idle(max_steps=400)
            after = s.S._job_bytes_per_device(N, srv.env, False)
            return {"jobs": jobs, "before": before, "after": after}

        ref, port = _twin(monkeypatch, scenario, R=8)
        assert_twins(ref, port)
        assert port[1]["after"] == 2 * port[1]["before"]
        assert (port[1]["before"], port[1]["after"]) == \
            (ref[1]["before"], ref[1]["after"])

    def test_failover_refreshes_the_governor_budget(self, monkeypatch):
        """The mesh listener re-derives the budget on the announced loss:
        the resident ledger is re-priced against the register's env."""
        seen = []
        monkeypatch.setattr(PG, "refresh_budget",
                            lambda: seen.append("refresh"))
        srv = PS.SimServer(port_env(8), window=4, max_batch=8,
                           faults=PR.FaultPlan("shard_loss@1"))
        try:
            srv.submit(circ(PC, 0.3), num_qubits=N)
            srv.run_until_idle(max_steps=400)
        finally:
            srv.close()
        assert seen == ["refresh"]

    def test_checkpoint_refused_on_torch_distributed_ranks(self):
        """A register split over torch.distributed ranks cannot be
        checkpointed (checkpoint.py), so preempt='checkpoint' is refused
        at construction; 'pause' and 'off' are accepted."""
        from quest_tpu_torch.env import QuESTEnv
        from quest_tpu_torch.parallel.mesh import DistMesh

        mesh = DistMesh.__new__(DistMesh)
        mesh.devices = (PC.torch.device("cpu"),) * 2
        mesh.local = (0,)
        env = QuESTEnv(device=mesh.devices[0], num_ranks=2,
                       devices=mesh.devices, mesh=mesh)
        with pytest.raises(tq.QuESTError, match="torch.distributed"):
            PS.SimServer(env)
        for mode in ("pause", "off"):
            PS.SimServer(env, preempt=mode).close()


class TestObservability:
    THETAS = (0.3, 0.45, 0.6)

    def test_retried_job_trace_complete_and_well_nested(
            self, monkeypatch):
        ref, port = _twin(monkeypatch, _trace(self.THETAS,
                                              faults="bank_fault@1"))
        assert_twins(ref, port)
        srv = port[0].servers[0]
        rsrv = ref[0].servers[0]
        for j, rj in zip(port[1]["jobs"], ref[1]["jobs"]):
            assert j.state == PS.DONE and j.attempts == 2
            tz = srv.tracez(j)
            assert tz["complete"] and not tz["open"]
            names = [e["name"] for e in tz["events"]]
            assert names[0] == "job"
            assert names.count("serve.bank_join") == 2
            assert names.index("serve.admit") \
                < names.index("serve.retry") \
                < names.index("serve.complete")
            assert "serve.window" in names
            roots = tz["tree"]
            assert len(roots) == 1 and roots[0]["name"] == "job"
            assert roots[0]["args"]["status"] == "done"
            assert len(roots[0]["children"]) == len(names) - 1
            assert srv.tracez(j.id) == tz
            # the same lifecycle, event for event, as the reference's
            assert names == [e["name"] for e in rsrv.tracez(rj)["events"]]

    def test_quarantine_writes_parseable_flight_dump(
            self, tmp_path, monkeypatch):
        def scenario(s):
            monkeypatch.setenv("QT_SERVE_FLIGHT_DIR",
                               str(tmp_path / s.name))
            srv = s.server(window=4, max_batch=8, watchdog=1,
                           quarantine=(1, 3600.0))
            bad = srv.submit(s.circ(0.4), num_qubits=N, tenant="eve")
            srv.faults = s.plan(f"poison_job@{bad.id}")
            srv.run_until_idle(max_steps=400)
            docs = []
            for p in srv.flight_dumps:
                with open(p) as f:
                    docs.append(json.load(f))
            return {"jobs": [bad], "docs": docs}

        ref, port = _twin(monkeypatch, scenario)
        assert_twins(ref, port)
        (bad,) = port[1]["jobs"]
        assert bad.state == PS.FAILED
        docs = port[1]["docs"]
        assert [d["reason"] for d in docs] == \
            [d["reason"] for d in ref[1]["docs"]]
        (doc,) = [d for d in docs if d["reason"] == "quarantine"]
        assert doc["context"]["tenant"] == "eve"
        assert doc["context"]["job"] == bad.id
        assert doc["context"]["trace_id"] == bad.trace_id
        kinds = [e["kind"] for e in doc["events"]]
        assert "bisect" in kinds
        assert any(e.get("name") == "serve.quarantine"
                   for e in doc["events"])

    def test_metrics_endpoint_byte_matches_exposition(self):
        srv = PS.SimServer(port_env(1), window=4, max_batch=8)
        try:
            host, port = srv.serve_http()
            assert srv.serve_http() == (host, port)
            job = srv.submit(circ(PC, 0.3), num_qubits=N, seed=100,
                             measure=(0, 2))
            srv.run_until_idle(max_steps=400)
            base = f"http://{host}:{port}"
            body = urllib.request.urlopen(base + "/metrics",
                                          timeout=10).read()
            assert body == PT.prometheus_text().encode("utf-8")
            with urllib.request.urlopen(base + "/healthz",
                                        timeout=10) as r:
                hz = json.load(r)
            assert hz["status"] == "ok" and hz["queue_depth"] == 0
            assert hz["completed"] == 1 and hz["devices"] >= 1
            assert hz == srv._healthz()
            with urllib.request.urlopen(
                    base + f"/tracez/{job.trace_id}", timeout=10) as r:
                tz = json.load(r)
            assert tz["complete"] and tz == srv.tracez(job)
            with urllib.request.urlopen(base + "/tracez?id="
                                        + job.trace_id, timeout=10) as r:
                assert json.load(r) == tz
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/tracez/nope", timeout=10)
            assert ei.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(base + "/nowhere", timeout=10)
            assert ei.value.code == 404
        finally:
            srv.close()
        assert srv._http is None

    def test_healthz_keys_are_the_references(self):
        srv = PS.SimServer(port_env(1))
        ref = qt.serve.SimServer(qt.createQuESTEnv(num_devices=1))
        try:
            assert srv._healthz() == ref._healthz()
        finally:
            srv.close()
            ref.close()


class TestWarmPool:
    def test_prewarm_reports_disabled_and_keeps_its_bookkeeping(
            self, monkeypatch):
        """Without a plan cache every spec is "disabled", as the reference
        reports with its cache off; the specs are still exported and
        adopted."""
        def scenario(s):
            srv = s.server(window=4, max_batch=8, prewarm=True)
            jobs = [srv.submit(s.circ(0.3), num_qubits=N, seed=1)]
            srv.run_until_idle(max_steps=200)
            assert srv.prewarm_join(timeout=30.0)
            ws = srv.export_warmset()
            other = s.server(window=4, max_batch=8, prewarm=True)
            n_new = other.warm_from(ws)
            assert other.prewarm_join(timeout=30.0)
            return {"jobs": jobs,
                    "specs": sorted((w["n"], w["batch"], w["dtype"],
                                     w["ndev"]) for w in ws),
                    "new": n_new, "health": srv._healthz()}

        ref, port = _twin(monkeypatch, scenario, R=8)
        assert_twins(ref, port)
        assert port[1]["specs"] == ref[1]["specs"] == [
            (N, 1, "float64", 4), (N, 1, "float64", 8)]
        assert port[1]["new"] == ref[1]["new"] == 2
        assert port[1]["health"]["warm_pool_depth"] == 0
        assert counters(port)["serve_prewarm_total"] == \
            {"status=disabled": 4.0}


def torch_oom(msg):
    import torch

    return torch.OutOfMemoryError(msg)


# ---------------------------------------------------------------------------
# scripts/chaos_serve.py's invariants (a)-(f) on the port
# ---------------------------------------------------------------------------

CHAOS_JOBS = 12
CHAOS_TENANTS = ("alice", "bob", "carol")
CHAOS_BOUND = 2000


def _chaos_trace(seed):
    rng = np.random.RandomState(seed)
    jobs = []
    for _ in range(CHAOS_JOBS):
        tenant = CHAOS_TENANTS[int(rng.randint(len(CHAOS_TENANTS)))]
        theta = float(rng.uniform(0.1, 2.8))
        prio = PS.INTERACTIVE if rng.rand() < 0.25 else PS.BATCH
        jobs.append((tenant, theta, prio, (0, N - 1)))
    return jobs


def _chaos_schedule(seed):
    """chaos_serve.py's seed-derived fault plan: a bank fault, IO faults,
    a shard or host loss and a heal, an OOM (twice on odd seeds, past
    the net's retry) and one poisoned job."""
    rng = np.random.RandomState(seed ^ 0x5EED)
    loss_kind = "host_loss" if seed % 2 == 0 else "shard_loss"
    loss_at = int(rng.randint(6, 10))
    heal_at = loss_at + int(rng.randint(4, 8))
    oom_at = int(rng.randint(2, 5))
    parts = [f"bank_fault@{int(rng.randint(2, 6))}", "io@2",
             f"{loss_kind}@{loss_at}", f"heal@{heal_at}", f"oom@{oom_at}"]
    if seed % 2 == 1:
        parts.append(f"oom@{oom_at}")
    poison = int(rng.randint(0, CHAOS_JOBS))
    parts.append(f"poison_job@{poison}")
    return ",".join(parts), {poison}


def _chaos_run(spec, seed):
    PR.seed_backoff_jitter(list(JITTER))
    env = tq.createQuESTEnv(devices=["cpu"] * 8)
    tq.seedQuEST(env, [seed])
    plan = PR.FaultPlan(spec) if spec else None
    srv = PS.SimServer(env, window=4, max_batch=4, retries=4, watchdog=1,
                       quarantine=(100, 3600.0), faults=plan, prewarm=True)
    # the jobs that ran a window on another mesh than the baseline's: in a
    # started bank at a failover or heal, or started while degraded
    moved = set()

    def mark(fn):
        def wrapped(*args):
            moved.update(j.id for b in srv._banks if b.started
                         for j in b.jobs)
            return fn(*args)
        return wrapped

    def start(bank, _orig=srv._start):
        _orig(bank)
        if srv.env is not srv._full_env:
            moved.update(j.id for j in bank.jobs)

    srv._failover = mark(srv._failover)
    srv.heal = mark(srv.heal)
    srv._start = start
    handles = []
    try:
        for i, (tenant, theta, prio, measure) in enumerate(
                _chaos_trace(seed)):
            handles.append(srv.submit(circ(PC, theta), num_qubits=N,
                                      tenant=tenant, priority=prio,
                                      measure=measure))
            if i % 3 == 2:
                for _ in range(2):
                    srv.step()
        steps = srv.run_until_idle(max_steps=CHAOS_BOUND)
        stats = srv.stats()
        out = {h.id: {"tenant": h.tenant, "state": h.state,
                      "attempts": h.attempts,
                      "amps": None if h.amps is None
                      else np.asarray(h.amps).tobytes(),
                      "outcomes": tuple(h.outcomes),
                      "key": None if h.key_state is None
                      else (tuple(h.key_state["key"]),
                            h.key_state["counter"])}
               for h in handles}
        dumps = []
        for p in srv.flight_dumps:
            with open(p) as f:
                dumps.append(json.load(f))
        traces = {h.id: srv.tracez(h) for h in handles}
        return out, stats, steps, plan, dumps, traces, moved
    finally:
        srv.close()


class TestChaos:
    @pytest.mark.parametrize("seed", [11, 12])
    def test_chaos_invariants(self, seed, monkeypatch):
        monkeypatch.setenv("QT_TOPOLOGY", "2x4")
        monkeypatch.setenv("QT_RETRY_ATTEMPTS", "3")
        base = _chaos_run("", seed)[0]
        spec, poisoned = _chaos_schedule(seed)
        PT.reset()
        chaos, stats, steps, plan, dumps, traces, moved = _chaos_run(
            spec, seed)
        # (c) idle within the bound, queues empty, no resident bank
        assert steps < CHAOS_BOUND
        assert stats["queued"] == 0 and stats["banks"] == 0
        assert PG.resident_bytes() == 0
        # (b) + (d): only the poisoned job fails; availability 100 %
        failed = {j for j, r in chaos.items() if r["state"] != "done"}
        assert failed == poisoned
        completed = [j for j in chaos if j not in poisoned]
        # (a) every completion bit for bit the fault-free replay, but a
        # job that ran windows on the shrunk mesh: those were planned at
        # another shard width, so their sums run in another order, and it
        # is held within the reference test's bound for such jobs
        # (ROADMAP Queue 3, the failover's tolerance)
        assert moved & set(completed)
        for j in completed:
            assert chaos[j]["outcomes"] == base[j]["outcomes"] \
                or j in moved, j
            assert chaos[j]["key"] == base[j]["key"], j
            if j not in moved:
                assert chaos[j]["amps"] == base[j]["amps"], j
                continue
            a = np.frombuffer(chaos[j]["amps"], dtype=np.float64)
            b = np.frombuffer(base[j]["amps"], dtype=np.float64)
            assert np.abs(a - b).max() <= 1e-13, j
            assert [o for o, _p in chaos[j]["outcomes"]] == \
                [o for o, _p in base[j]["outcomes"]], j
        fired = {e.split("@")[0] for e in plan.log}
        assert {"bank_fault", "heal", "poison_job", "io"} <= fired
        assert PT.counter_total("serve_failovers_total") == 1
        assert PT.counter_total("serve_heals_total") == 1
        assert not stats["degraded"] and stats["devices"] == 8
        # (e) the quarantine and failover incidents left parseable dumps
        reasons = [d["reason"] for d in dumps]
        for d in dumps:
            assert isinstance(d["events"], list)
        assert "quarantine" in reasons and "failover" in reasons
        # (f) every completion's trace is complete and well nested, the
        # lifecycle in order, a retry visible for every re-run job
        for j in completed:
            tz = traces[j]
            assert tz["complete"] and not tz["open"]
            names = [e["name"] for e in tz["events"]]
            order = [names.index(n) for n in (
                "serve.admit", "serve.bank_join", "serve.window",
                "serve.complete")]
            assert order == sorted(order)
            roots = tz["tree"]
            assert len(roots) == 1 and roots[0]["name"] == "job"
            if chaos[j]["attempts"] > 1:
                assert "serve.retry" in names
