"""One serving scenario run through both packages' SimServer.

A scenario is a function of one :class:`Side`: it builds servers with
``side.server(...)``, submits gate streams built from ``side.C.Gate``
(``circ``) and returns the jobs it wants compared.  :func:`twin` runs it
against the JAX package (``quest_tpu.serve`` on ``num_devices`` devices
of the suite's CPU mesh) and against the port (``quest_tpu_torch.serve``
on an in-process CPU mesh of as many shards), each side with its own
telemetry registry reset first and its own deterministic clock: both
serve modules read ``time.monotonic`` / ``time.sleep`` from a
:class:`Clock` that advances only when the server sleeps, so backoff
gates and breaker timeouts fall on the same steps in both packages
however long a drain takes on either.  :func:`assert_twins` holds the
port's run to the reference's: every job's state, attempts, amplitudes
(within 1e-10), outcomes and their probabilities, key state and error
chain; each server's schedule (step, bank, job ids, cursor after),
``stats()`` and rejections; and the ``serve_*`` counters.
"""

from __future__ import annotations

import time
from typing import Callable, List

import numpy as np

import quest_tpu as qt
from quest_tpu import batch as RB
from quest_tpu import circuit as RC
from quest_tpu import resilience as RR
from quest_tpu import serve as RS
from quest_tpu import telemetry as RT
import quest_tpu_torch as tq
from quest_tpu_torch import batch as PB
from quest_tpu_torch import circuit as PC
from quest_tpu_torch import resilience as PR
from quest_tpu_torch import serve as PS
from quest_tpu_torch import telemetry as PT

N = 4
TOL = 1e-10


def _h(C, t):
    m = np.array([[1.0, 1.0], [1.0, -1.0]]) / np.sqrt(2.0)
    return C.Gate((t,), np.stack([m, np.zeros((2, 2))]))


def _rz(C, t, theta):
    d = np.exp(1j * np.array([-theta / 2, theta / 2]))
    return C.Gate((t,), np.stack([np.diag(d.real), np.diag(d.imag)]))


def circ(C, theta, depth=3, n=N):
    """tests/test_serve.py's circuit: layers of H and Rz on every qubit."""
    gates = []
    for d in range(depth):
        for q in range(n):
            gates.append(_h(C, q))
            gates.append(_rz(C, q, theta + 0.1 * q + d))
    return gates


class Clock:
    """A monotonic clock that moves only when the server sleeps (and a
    real perf_counter, for the latencies the servers record)."""

    def __init__(self):
        self.t = 1000.0

    def monotonic(self) -> float:
        return self.t

    def sleep(self, d: float) -> None:
        self.t += max(0.0, float(d))

    @staticmethod
    def perf_counter() -> float:
        return time.perf_counter()


class Side:
    """One package's modules, env and the records of one scenario run."""

    def __init__(self, name, qt_mod, S, C, R, T, B, env):
        self.name = name
        self.qt = qt_mod
        self.S = S
        self.C = C
        self.R = R
        self.T = T
        self.B = B
        self.env = env
        self.servers: List = []
        self.schedules: List[list] = []
        self.rejections: List[tuple] = []
        self.stats: List[dict] = []

    def circ(self, theta, depth=3, n=N):
        return circ(self.C, theta, depth, n)

    def plan(self, spec):
        return self.R.FaultPlan(spec) if spec else None

    def server(self, **kw):
        """A SimServer on this side's env whose every advance is logged:
        (step, bank seq, job ids, cursor after or None)."""
        if "faults" in kw and isinstance(kw["faults"], str):
            kw["faults"] = self.plan(kw["faults"])
        srv = self.S.SimServer(kw.pop("env", self.env), **kw)
        log: list = []
        orig = srv._advance

        def advance(bank):
            step = srv._step_count - 1
            ids = tuple(j.id for j in bank.jobs)
            orig(bank)
            after = bank.ex.cursor if bank.ex is not None else None
            log.append((step, bank.seq, ids, after))

        srv._advance = advance
        self.servers.append(srv)
        self.schedules.append(log)
        return srv

    def submit(self, srv, gates, **kw):
        """srv.submit, recording a refusal's (tenant, kind, limit, value)
        before re-raising it."""
        try:
            return srv.submit(gates, **kw)
        except self.S.QuotaExceededError as e:
            self.rejections.append((e.tenant, e.kind, e.limit, e.value))
            raise


def ref_env(R: int):
    return qt.createQuESTEnv(num_devices=R)


def port_env(R: int):
    return tq.createQuESTEnv(devices=["cpu"] * R) if R > 1 \
        else tq.createQuESTEnv(device="cpu")


def sides(R: int = 1):
    return (Side("ref", qt, RS, RC, RR, RT, RB, ref_env(R)),
            Side("port", tq, PS, PC, PR, PT, PB, port_env(R)))


def serve_counters(T) -> dict:
    """Every ``serve_*`` counter and ``preemptions_total``, by label."""
    snap = T.snapshot()
    return {name: dict(by_label)
            for name, by_label in snap.get("counters", {}).items()
            if name.startswith("serve_") or name == "preemptions_total"}


def twin(scenario: Callable, R: int = 1, monkeypatch=None, jitter=None):
    """Run ``scenario`` on the reference, then on the port; returns
    ``(ref, port)``, each ``(side, result, counters)``.  ``jitter``
    seeds both packages' backoff-jitter streams before each run."""
    out = []
    for side in sides(R):
        side.T.reset()
        if monkeypatch is not None:
            monkeypatch.setattr(side.S, "time", Clock())
        if jitter is not None:
            side.R.seed_backoff_jitter(list(jitter))
        try:
            result = scenario(side)
            side.stats = [srv.stats() for srv in side.servers]
        finally:
            for srv in side.servers:
                srv.close()
        out.append((side, result, serve_counters(side.T)))
    return tuple(out)


def job_record(job):
    return {
        "id": job.id, "tenant": job.tenant, "state": job.state,
        "attempts": job.attempts,
        "outcomes": [o for o, _p in job.outcomes],
        "key": None if job.key_state is None else (
            [int(x) for x in np.asarray(job.key_state["key"]).ravel()],
            int(job.key_state["counter"])),
        "errors": [e.split(":")[0] + ":" + e.split(":")[1]
                   for e in job.errors],
        "error": None if job.error is None else type(job.error).__name__,
    }


def assert_jobs(ref_jobs, port_jobs, tol=TOL):
    assert len(ref_jobs) == len(port_jobs)
    for rj, pj in zip(ref_jobs, port_jobs):
        assert job_record(pj) == job_record(rj)
        assert (pj.amps is None) == (rj.amps is None)
        if rj.amps is not None:
            a = np.asarray(pj.amps)
            b = np.asarray(rj.amps)
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= tol
        assert np.allclose([p for _o, p in pj.outcomes],
                           [p for _o, p in rj.outcomes], rtol=0, atol=tol)


def assert_twins(ref, port, *, jobs_key="jobs", tol=TOL):
    """The port's run equals the reference's run of the same scenario."""
    rside, rres, rcount = ref
    pside, pres, pcount = port
    assert_jobs(rres[jobs_key], pres[jobs_key], tol)
    assert pside.schedules == rside.schedules
    assert pside.rejections == rside.rejections
    assert pside.stats == rside.stats
    assert pcount == rcount
